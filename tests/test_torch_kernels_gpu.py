"""Card-only checks of the port's hand-written kernels (``gpu`` marker).

Each kernel against its plain PyTorch version on the card, at small sizes,
for every optimizer kind and both operand forms.  They skip without a CUDA
card (a CUDA kernel has no CPU mode).  This file imports neither jax nor the
JAX package, so it also runs on a machine without them:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest``
(the repository's ``conftest.py`` imports jax).  ``chip_smoke.py`` runs the
full-width version of these checks.
"""

import numpy as np
import pytest
import torch

from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.ops import fat_lines as tfl
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk

KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [16, 64])
def test_fat_line_update_matches_plain_on_card(kind, d):
    """Every kind, row form (R == 1) and packed form (R > 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    lay = tfl.line_layout(d, kind)
    v, b = 4000, 512
    fat = tfl.fat_pack(torch.randn(v, d), kind=kind).cuda()
    ids = torch.from_numpy(rng.integers(-1, v, b)).cuda()
    ul, seg, _ = tsp.dedupe_ids(ids, vocab=v, rows_per_line=lay.r)
    c = ul.shape[0]
    g = tsp._segment_sum(torch.randn(b, d, device="cuda"), seg, c * lay.r)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    if lay.r == 1:
        g, tl = g.view(c, d), None
    else:
        g = g.view(c, lay.r, d)
        tl = (tsp._segment_sum((ids >= 0).float(), seg, c * lay.r) > 0
              ).float().view(c, lay.r)
    a, k = fat.clone(), fat.clone()
    tk.fat_line_update_plain(a, ul, g, tl, corr, layout=lay, lr=0.05,
                             weight_decay=1e-2)
    tk.fat_line_update(k, ul, g, tl, corr, layout=lay, lr=0.05,
                       weight_decay=1e-2)
    torch.cuda.synchronize()
    rtol, atol = TOL["optimizer"]
    torch.testing.assert_close(k, a, rtol=rtol, atol=atol)
    launches = tk.fat_line_update.launches
    tk.fat_line_update(k, ul, g, tl, corr, layout=lay, lr=0.05)
    assert tk.fat_line_update.launches == launches + 1


@pytest.mark.gpu
def test_fat_line_update_refuses_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay = tfl.line_layout(64, "adam")
    fat = torch.zeros((4, lay.tiles, 128), device="cuda")
    ul = torch.tensor([0, 1], dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError, match="ulines"):
        tk.fat_line_update(fat, ul, torch.zeros(2, 64, device="cuda"), None,
                           torch.ones(2, device="cuda"), layout=lay, lr=0.1)
