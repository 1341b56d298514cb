"""The dense TwoTower regime (``model_parallel = false``, the quickstart's)
of the PyTorch port against the JAX package, on the CPU.

* The JAX package's ``init_twotower`` params are injected through
  ``interop.dense_params_from_flax`` (``load_state_dict(strict=True)``):
  forward logits agree within ``TOL["logits"]``; three steps of
  ``train.step.make_train_step`` (every table under AdamW, lr 3e-4, wd
  1e-4) give losses and every parameter within ``TOL["trajectory"]`` of
  ``tdfo_tpu.train.step.make_train_step``, the rows no id touched included
  (the decay still moves them).
* Under a dynamic loss scale (the f16 path's), a step whose loss or
  gradients are not finite keeps the parameters and AdamW's state and
  halves the scale; a finite step then updates and counts toward growth.
* The Trainer: an epoch with ``steps_per_execution = 4`` equals single
  steps bitwise; ``profile = true`` writes a Chrome trace; ``use_tpu =
  true`` refuses.
* ``tdfo_tpu_torch.launch train --device cpu`` (the entry point of ``python
  -m tdfo_tpu_torch.launch``) trains a copy of the quickstart ``config.toml``
  whose only change is ``data_dir``; without ``--device cpu`` and with no
  card it refuses.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.models.twotower import init_twotower as j_init
from tdfo_tpu.train.state import TrainState as JState
from tdfo_tpu.train.state import make_adamw as j_adamw
from tdfo_tpu.train.step import make_train_step as j_make_step
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.core.precision import DynamicLossScale
from tdfo_tpu_torch.interop import TOL, dense_params_from_flax
from tdfo_tpu_torch.models.twotower import TwoTower
from tdfo_tpu_torch.train.state import TrainState
from tdfo_tpu_torch.train.step import make_eval_step, make_train_step
from tdfo_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and the suite runs
    several test processes at once, whose thread pools would otherwise
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
SIZE_MAP = {"user": 60, "item": 40, "language": 5, "is_ebook": 2,
            "format": 4, "publisher": 7, "pub_decade": 6}
D, B, LR, WD = 16, 32, 3e-4, 1e-4


def _batch(rng):
    b = {("user_id" if f == "user" else "item_id" if f == "item" else f):
         rng.integers(0, v, B).astype(np.int32) for f, v in SIZE_MAP.items()}
    b["avg_rating"] = rng.uniform(0, 5, B).astype(np.float32)
    b["num_pages"] = rng.uniform(0, 1, B).astype(np.float32)
    b["label"] = rng.integers(0, 2, B).astype(np.float32)
    return b


def _pair():
    model, params = j_init(jax.random.key(0), SIZE_MAP, D)
    sd = dense_params_from_flax(jax.tree.map(np.asarray, params))
    tm = TwoTower(SIZE_MAP, D)
    tm.load_state_dict(sd, strict=True)
    return model, params, tm


def test_forward_logits_match_jax():
    model, params, tm = _pair()
    b = _batch(np.random.default_rng(1))
    want = np.asarray(jax.jit(model.apply)({"params": params},
                                           {k: jnp.asarray(v) for k, v in b.items()}))
    got = make_eval_step()(TrainState.create(model=tm, learning_rate=LR,
                                             weight_decay=WD),
                           {k: torch.from_numpy(v) for k, v in b.items()})[1]
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_three_steps_match_jax():
    model, params, tm = _pair()
    jstate = JState.create(apply_fn=model.apply, params=params, tx=j_adamw(LR, WD))
    jstep = j_make_step(donate_state=False)
    tstate = TrainState.create(model=tm, learning_rate=LR, weight_decay=WD)
    tstep = make_train_step()
    rng = np.random.default_rng(2)
    jl, tl = [], []
    for _ in range(3):
        b = _batch(rng)
        jstate, loss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        tstate, loss = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tl.append(float(loss))
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    want = dense_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = tstate.model.state_dict()
    assert want.keys() == got.keys() and tstate.step == 3
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol, msg=k)
    # a user row no batch touched moved by the decay alone
    seen = set()
    rng = np.random.default_rng(2)
    for _ in range(3):
        seen.update(_batch(rng)["user_id"].tolist())
    cold = sorted(set(range(SIZE_MAP["user"])) - seen)
    assert cold
    init = dense_params_from_flax(jax.tree.map(np.asarray, params))
    assert not torch.equal(got["user_embed.weight"][cold],
                           init["user_embed.weight"][cold])


def test_loss_scale_overflow_keeps_state():
    tm = TwoTower(SIZE_MAP, D, generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model=tm, learning_rate=LR, weight_decay=WD,
                              loss_scale=DynamicLossScale.create(initial_scale=2.0**10))
    before = state.snapshot()
    host = _batch(np.random.default_rng(3))
    bad = dict(host, avg_rating=np.where(np.arange(B) == 3, np.inf,
                                         host["avg_rating"]).astype(np.float32))
    state, loss = make_train_step()(state, {k: torch.from_numpy(v) for k, v in bad.items()})
    assert not np.isfinite(float(loss)) and state.step == 1
    after = state.state_dict()
    for k, v in before["params"].items():
        assert torch.equal(after["params"][k], v), k
    for i, st in before["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(after["optimizer"][i][k], v), (i, k)
    assert float(state.loss_scale.scale) == 2.0**9
    # a finite step then updates, and the scale holds
    state, loss = make_train_step()(state, {k: torch.from_numpy(v) for k, v in host.items()})
    assert np.isfinite(float(loss))
    assert not torch.equal(state.model.user_embed.weight,
                           before["params"]["user_embed.weight"])
    assert float(state.loss_scale.scale) == 2.0**9
    assert int(state.loss_scale.growth_counter) == 1


@pytest.fixture(scope="module")
def ctr_dir(tmp_path_factory):
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    d = tmp_path_factory.mktemp("dense")
    write_synthetic_goodreads(d)
    return d, run_ctr_preprocessing(d)


def _cfg(ctr_dir, **kw):
    d, size_map = ctr_dir
    body = dict(data_dir=str(d), model="twotower", embed_dim=8, n_epochs=1,
                per_device_train_batch_size=64, per_device_eval_batch_size=256,
                size_map=size_map, log_every_n_steps=5)
    body.update(kw)
    return read_configs(None, **body)


def test_steps_per_execution_is_bitwise(ctr_dir):
    trs = [Trainer(_cfg(ctr_dir, steps_per_execution=k), device="cpu")
           for k in (1, 4)]
    losses = [tr.train_epoch(0) for tr in trs]
    assert losses[0] == losses[1]
    a, b = (tr.state.state_dict() for tr in trs)
    assert a["step"] == b["step"] > 8 and a["step"] % 4  # a short tail chunk
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_profile_writes_trace_and_use_tpu_refuses(ctr_dir, tmp_path):
    tr = Trainer(_cfg(ctr_dir, profile=True, checkpoint_dir=str(tmp_path / "ck")),
                 device="cpu")
    tr.train_epoch(0)
    trace = json.loads((tmp_path / "ck" / "profile" / "trace_epoch0.json").read_text())
    assert trace["traceEvents"]
    with pytest.raises(RuntimeError, match="use_tpu"):
        Trainer(_cfg(ctr_dir, use_tpu=True), device="cpu")


def test_quickstart_config_trains_on_the_cpu(tmp_path, capsys):
    from tdfo_tpu_torch import launch

    text = (ROOT / "config.toml").read_text()
    assert 'data_dir = "data/goodreads"' in text and "model_parallel" not in text
    cfg = tmp_path / "config.toml"
    cfg.write_text(text.replace('data_dir = "data/goodreads"',
                                f'data_dir = "{tmp_path / "data"}"'))
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch.main(["train", "--config", str(cfg)])
    # the entry point of ``python -m tdfo_tpu_torch.launch``, in process
    tr = launch.run(["train", "--config", str(cfg), "--device", "cpu"])
    assert isinstance(tr.state, TrainState) and tr.state.step > 0
    assert "user_embed.weight" in capsys.readouterr().out  # its own tables
    assert tr.config.n_epochs == 2 and tr._logged_steps == tr.state.step
