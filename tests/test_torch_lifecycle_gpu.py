"""Card-only checks of the trainer lifecycle (``gpu`` marker): the dense
step as CUDA-graph replays, and checkpoints of card states.  They skip
without a CUDA card (a CUDA graph has no CPU mode).  This file imports
neither jax nor the JAX package, so it runs on the card's machine with
``python -m pytest tests/test_torch_lifecycle_gpu.py -m gpu --noconftest``.

* ``CudaGraphStep`` replays of the dense TwoTower step give the eager
  step's losses and state: bitwise where three eager runs agree bitwise,
  else inside their range widened by their spread (the tables' gradient
  is an ``index_add_``, whose float atomics may add in another order); a
  batch that is not on the card is refused.
* A card state restored from a checkpoint lands on the card, bitwise, with
  the capturable AdamW's step counter on the card; a CPU-written
  checkpoint restores into a card state and the reverse.
"""

import copy

import numpy as np
import pytest
import torch

from tdfo_tpu_torch.models.twotower import TwoTower
from tdfo_tpu_torch.train.checkpoint import CheckpointManager
from tdfo_tpu_torch.train.state import TrainState
from tdfo_tpu_torch.train.step import CudaGraphStep, make_multi_step, make_train_step

SIZE_MAP = {"user": 5000, "item": 3000, "language": 8, "is_ebook": 2,
            "format": 4, "publisher": 50, "pub_decade": 6}
D, B = 32, 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")


def _batches(n, device="cuda", seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {("user_id" if f == "user" else "item_id" if f == "item" else f):
             rng.integers(0, v, B).astype(np.int32) for f, v in SIZE_MAP.items()}
        b["avg_rating"] = rng.random(B).astype(np.float32)
        b["num_pages"] = rng.random(B).astype(np.float32)
        b["label"] = rng.integers(0, 2, B).astype(np.float32)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def _state(model0, device):
    return TrainState.create(model=copy.deepcopy(model0).to(device),
                             learning_rate=3e-4, weight_decay=1e-4,
                             capturable=device == "cuda")


def _diff(a, b):
    worst = 0.0
    for (ka, x), (kb, y) in zip(a.items(), b.items(), strict=True):
        assert ka == kb
        worst = max(worst, float((x.double() - y.to(x.device).double()).abs().max()))
    return worst


@pytest.mark.gpu
def test_graph_replays_match_eager_steps():
    _card()
    model0 = TwoTower(SIZE_MAP, D, generator=torch.Generator().manual_seed(0))
    batches = _batches(10)
    runs = []
    for _ in range(3):
        st, step, ls = _state(model0, "cuda"), make_train_step(), []
        for b in batches:
            st, loss = step(st, b)
            ls.append(loss)
        runs.append(dict(st.model.state_dict(), losses=torch.stack(ls)))
    sg = _state(model0, "cuda")
    multi = make_multi_step(CudaGraphStep(make_train_step()))
    losses = []
    for i in range(0, 10, 4):  # chunks of 4, 4 and a tail of 2
        chunk = {k: torch.stack([b[k] for b in batches[i:i + 4]]) for k in batches[0]}
        sg, ls = multi(sg, chunk)
        losses.append(ls)
    assert sg.step == 10
    got = dict(sg.model.state_dict(), losses=torch.cat(losses))
    bounds = {k: (torch.stack([r[k] for r in runs]).min(0).values,
                  torch.stack([r[k] for r in runs]).max(0).values) for k in got}
    spread = max(float((hi - lo).max()) for lo, hi in bounds.values())
    for k, x in got.items():
        lo, hi = bounds[k]
        assert float(torch.maximum(lo - x, x - hi).max()) <= spread, (k, spread)
    with pytest.raises(ValueError, match="on the card"):
        CudaGraphStep(make_train_step())(sg, _batches(1, device="cpu")[0])


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_card(tmp_path):
    _card()
    model0 = TwoTower(SIZE_MAP, D, generator=torch.Generator().manual_seed(1))
    batches = _batches(3)
    st, step = _state(model0, "cuda"), make_train_step()
    for b in batches:
        st, _ = step(st, b)
    mgr = CheckpointManager(tmp_path / "card")
    mgr.save(3, st)
    for device in ("cuda", "cpu"):
        fresh = _state(model0, device)
        mgr.restore(fresh)
        p = next(fresh.model.parameters())
        assert p.device.type == device
        assert fresh.optimizer.state[p]["step"].device.type == device
        assert fresh.step == 3
        assert _diff(fresh.model.state_dict(), st.model.state_dict()) == 0.0
    # a CPU-written checkpoint into a card state
    cpu = _state(model0, "cpu")
    for b in _batches(2, device="cpu"):
        cpu, _ = step(cpu, b)
    mgr2 = CheckpointManager(tmp_path / "cpu")
    mgr2.save(2, cpu)
    card = _state(model0, "cuda")
    mgr2.restore(card)
    assert next(card.model.parameters()).device.type == "cuda"
    assert _diff(card.model.state_dict(), cpu.model.state_dict()) == 0.0
