"""The ``fat_line_update`` design variants
(``tdfo_tpu_torch/tools/fat_line_variants.py``) are textual edits of the
kernel's committed source; each must still apply to it and change it, so
the tool keeps measuring what its names say.  The timing itself needs a
CUDA card and runs there."""

import pytest

from tdfo_tpu_torch.tools import fat_line_variants as fv


@pytest.mark.parametrize("name", sorted(fv.VARIANTS))
def test_variant_edits_apply(name):
    _, edits = fv.VARIANTS[name]
    if name == "kernel":
        assert edits == {}
    for f, eds in edits.items():
        src = (fv.CSRC / f).read_text()
        out = src
        for edit in eds:
            out = edit(out)
        assert out != src, (name, f)


def test_diagnostics_and_clean_l2_name_variants():
    assert set(fv.DIAGNOSTIC) <= set(fv.VARIANTS)
    assert set(fv.CLEAN_L2) <= set(fv.VARIANTS)
    assert "memonly" in fv.DIAGNOSTIC and "kernel" not in fv.DIAGNOSTIC
