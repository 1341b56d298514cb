#!/usr/bin/env python3
"""Drive the PyTorch port (``tdfo_tpu_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                # every phase, one card

Phases (each prints its lines; any failure raises, so the script never exits
0 after a failed phase):

0. device — requires ``torch.cuda.is_available()``; prints the card's name,
   the device count and ``nvidia-smi --query-gpu=name,power.limit``.
1. build — compiles every kernel of the port from ``tdfo_tpu_torch/ops/csrc``
   with ``nvcc`` (all at once) and prints the build time and ``-Xptxas -v``.
2. oracle — each kernel against its plain PyTorch version on the card, on
   the same inputs: ``fat_line_update`` for the 4 optimizer kinds x {d=64
   row form on a 500,000-row table with ~8,192 lines, d=16 packed form},
   plus sentinel / out-of-range lines and untouched shared-line slots.
   Touched rows within rtol 1e-6 / atol 1e-7; every other element of the
   table bitwise unchanged.  Then (phase ``timing``) CUDA-event times of the
   kernel and the plain version at the main path's shape, with L2 flushed
   before each launch, the kernel's ``torch.profiler`` device duration
   (CUPTI's kernel start to end) and the floor of both (an empty kernel),
   beside the bound (the larger of bytes / HBM rate and f32 operations /
   peak f32 rate), after holding the kernel against the plain version on
   those same operands; then the same at the kernel's other shapes, each
   on a line of its own with its byte bound: the Bert4Rec item table
   (200,002 rows, adam d = 64, one ``b4r_batch``'s lines) and config.toml's
   packed shape (adam d = 16, R = 2 with the touched mask, the 700,000
   user+item rows, B = 2048).
3. main path — the library flow of ``bench.py::build_sparse_train_bench``
   at full width (SIZE_MAP of ``bench.py:56-59``, B = 8192, d = 64, sparse
   adam + dense AdamW at lr 3e-4, wd 1e-4, random batches as
   ``bench.py:90-102``): 20 steps on the card with finite losses and one
   ``fat_line_update`` launch per fat array per step (``user`` and ``item``
   share one stacked array); then the first 3 steps again on the port's CPU
   path from the same initial state, holding losses and the touched rows of
   the ``user`` table to rtol 1e-4.
4. CLI — ``launch synth -> preprocess-ctr -> train`` in a temporary
   directory with ``model_parallel = true``, ``embed_dim = 16``,
   ``fused_table_threshold = 0`` (every table fat, packed R = 2 lines),
   ``n_epochs = 1``; ``metrics.jsonl`` must hold eval AUC.  Run twice: f32
   storage, then ``[embeddings] table_dtype = "bfloat16"`` (the packed bf16
   fat stack through the bf16 kernel; every table still bf16 after
   training).
5. flash_oracle — the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain versions on the card, f32 and bf16, T in {20, 100,
   4096} (B = H = 2) and the kernels' tile edges T in {1, 15, 16, 17, 24,
   25, 31, 33, 63, 64, 65, 127, 128, 257} (B = H = 3: 9 heads, not a
   multiple of the heads a block packs), Dh in {32,
   64}, with key padding (a whole first key tile masked at T >= 80), a fully
   masked batch row (output 0, lse = +inf, zero gradients) and ragged last
   tiles.  f32: forward and lse within
   rtol/atol 2e-5, gradients within 1e-4 (summation order only, the JAX
   tests' own bounds).  bf16: compared in bf16, within 2e-2 relative plus
   2e-2 of the largest |value| (the kernel and its plain version round p,
   ds and the result to bf16 at the same places, so a different f32
   summation order can move a rounding by one bf16 ulp, 2^-8); the tile-edge
   cases add 1e-6 absolute, as the card tests do, since at T = 1 dQ is 0
   up to the rounding of dp - delta.
6. flash_timing — CUDA-event times and profiler device durations of each
   flash kernel (and the empty-kernel floor), CUDA-event times of its plain
   version, and CUDA-event times and profiler device durations (every kernel
   of one call, summed) of ``torch.nn.functional.scaled_dot_product_attention``
   with the same boolean mask (the yardstick, timed only; the backward
   kernels' yardstick is SDPA's whole backward), L2 flushed before each
   launch, beside the
   bound (the larger of bytes / HBM rate and 4, 6 or 8 B H T^2 Dh flops /
   peak rate for the operand type), at the Bert4Rec main path's shape (B =
   256, H = 2, T = 20, Dh = 32, f32) and at ``bench_kernels.py:23``'s (B =
   1, H = 8, T = 4096, Dh = 64) in bf16 and f32.
7. b4r_main — Bert4Rec sparse training with ``attn = "flash"`` at the full
   width of ``configs/bert4rec.toml`` (d = 64, 2 heads, 2 layers, ff 256, T =
   20, B = 256, dropout 0.1, adam lr 3e-4, wd 1e-4) over the catalogue of
   ``bench.py::bench_serve_seq`` (200,000 items; a fat item table): 20 steps
   with finite losses, n_layers launches per step of each flash kernel and
   one of ``fat_line_update``; then the first 3 steps at dropout 0 on the
   card and on the port's CPU path from one initial state: losses within
   rtol 1e-4, and the touched item rows too, except at most 0.1% of their
   elements, each within 2 lr per step (Adam's step on a gradient element
   that lies inside the two devices' f32 summation noise may take either
   sign).
8. b4r_cli — ``launch synth -> preprocess-seq -> train`` with ``model =
   "bert4rec"``, ``attn = "flash"``, ``fused_table_threshold = 0``;
   ``metrics.jsonl`` must hold Recall/NDCG@{10,20,50} and ``test_*``, and
   every kernel must have launched.

9. routed_oracle — ``fat_line_update_routed`` against its plain version on
   the card, on the same operands: the 4 kinds at d = 16 (packed, R = 2-8),
   rowwise_adagrad on the full 4.32 GB Criteo fat stack; rowwise_adagrad at
   d = 8 (R = 8); adam at d = 64 (R = 1, two tiles); with negative ids (the
   sentinel row and line), capacity padding rows and distinct rows sharing
   a line; then every line of a case holding R touched rows (rowwise d = 16,
   adam d = 32, sgd d = 8; 100,000-640,000 rows, more than the resident
   grid updates in one pass and a multiple of no row group).  Touched rows within rtol 1e-6 / atol 1e-7, every other element
   bitwise unchanged, and the kernel bitwise equal to ``fat_line_update``
   fed the same update in slot space.
10. routed_timing — CUDA-event times of the routed kernel and its plain
   version at the DLRM main path's shape (the 8 fat tables' 65,536 ids of
   one B = 8192 step on the 4.32 GB stack), L2 flushed before each launch,
   the kernel's profiler device duration and the empty-kernel floor,
   beside the byte bound.
11. dlrm_main — DLRM-Criteo sparse training at full width, the library flow
   of ``bench.py::build_criteo_train_bench`` as the planner bench's
   defaults arm calls it (``bench.py:492-493``): the 26 Criteo-Kaggle tables
   of ``bench.py:64-68`` at d = 16, the 8 tables above 16,384 rows in one
   rowwise-adagrad fat stack (``[8,428,795, 1, 128]`` f32), the 18 others in
   one plain stack, B = 8192 with 13 continuous columns (uniform ids, as
   ``bench.py:248-265``), ``DLRMBackbone`` (bottom (64,), top (128, 64)),
   sparse rowwise_adagrad lr 3e-4, dense AdamW lr 3e-4 wd 1e-4,
   ``dedup_lookup``; f32 compute (the bench computes the dense half in
   bf16; ``mixed_precision`` is not ported).  20 steps with finite losses,
   one routed launch and no ``fat_line_update`` launch per step, median
   step time and peak device memory; then 3 steps on the card and on the
   port's CPU path from one initial state: losses and the touched rows of
   both stacks within rtol 1e-4.
12. dlrm_cli — ``launch synth-criteo -> preprocess-criteo -> train`` with a
   copy of ``configs/dlrm-criteo.toml`` whose ``fused_table_threshold`` is
   lowered so a fat and a plain stack exist; ``metrics.jsonl`` must hold
   eval AUC and the routed kernel must have launched.

13. bf16_oracle — both bf16 kernels against their plain versions on the
   card, same operands and stochastic-rounding seed: ``fat_line_update`` for
   the 4 kinds at d = 64 on a bf16 500,000-row table with ~8,192 lines and
   packed at d = 16 with padding ids, and sentinel / out-of-range lines
   with untouched shared slots; the routed kernel at d = 16 (R = 2-8),
   adagrad and rowwise on the full 2.16 GB bf16 Criteo stack, adam at
   d = 64, and the hand-made edge lines.  Touched elements bitwise the plain version's
   wherever the f32 kernel is bitwise its plain version on the same
   widened operands, else one bf16 ulp apart (counted and printed);
   everything else bitwise unchanged; another seed changes the bits; the
   routed kernel bitwise ``fat_line_update`` given the routed grid's lines
   per block.
14. bf16_timing — both bf16 kernels at their paths' shapes (the TwoTower
   bf16 stack, the DLRM bf16 stack with one step's routing), timed as in
   ``timing`` beside the byte bound (bf16 table and state read and
   written, the f32 grads, the routing).
15. main_bf16 — ``bench.py::build_sparse_train_bench(8192, 64,
   table_dtype="bfloat16")``: every table bf16 (the fat stack with its adam
   state in the line, the small tables with the bench's f32 mu/nu),
   stochastically rounded writes, the backbone in bf16 as the bench
   computes it on a chip; 20 steps (finite losses, one ``fat_line_update``
   launch per step, the tables still bf16), median step time and peak
   memory; then 3 steps on the card and the CPU path from one state:
   losses within ``BF16_LOSS_RTOL``, at most ``BF16_FAR_SHARE`` of the
   touched user elements more than one bf16 ulp apart, none beyond one
   ulp plus 2 lr per step, and the initial rows, as a control, outside
   that share (the note at ``BF16_FAR_SHARE``).
16. dlrm_bf16_main — phase 11 with ``table_dtype = "bfloat16"`` under
   sparse adagrad (``DLRM_BF16_KIND``: the reference refuses bf16 fused
   tables under rowwise_adagrad): the bf16 adagrad fat stack
   ``[8,428,795, 1, 128]`` (2.16 GB) and bf16 plain stack, bf16 compute
   (``bench.py:306``); the same checks on both stacks, one routed launch
   per step.

17. dense_main — the dense TwoTower (``model_parallel = false``, the
   quickstart's regime) at ``bench.py::build_train_bench``'s width
   (SIZE_MAP, B = 8192, d = 64, every parameter under AdamW lr 3e-4 wd
   1e-4; f32 compute, the cut: the bench computes in bf16 on a chip): 20
   eager steps three times (finite losses), 20 steps with
   ``steps_per_execution = 4`` as CUDA-graph replays
   (``train/step.py::CudaGraphStep``) held to the eager runs by the rule of
   phase 18, eager vs graph step ms, a checkpoint of
   the capturable state restored bitwise into a card and a CPU state, and
   the first 3 steps on the port's CPU path (losses and touched user rows
   within rtol 1e-4).  No hand-written kernel is on this path.
18. resume — phases 3, 15 and 7's setups at their widths: 20
   uninterrupted steps three times, then 10 steps, a checkpoint save, a
   restore into a fresh state (bitwise the saved one) and 10 more (R,
   Bert4Rec's dropout drawn per step from ``(seed + 1, step)``).  When
   the uninterrupted runs agree bitwise R must equal them bitwise, else
   every loss and state element of R must lie within their range widened
   by their spread (the largest difference between two of them; card runs
   differ by ``index_add_``'s float atomics), both printed; each run
   launches ``fat_line_update`` once per step and, for Bert4Rec, each
   flash kernel once per layer per step.
   Prints the checkpoint's bytes and save / restore seconds.
19. quickstart_cli — ``launch synth -> preprocess-ctr -> train`` with a
   copy of ``config.toml`` (only ``data_dir``, ``n_epochs = 1``,
   ``checkpoint_dir``, ``checkpoint_every_n_steps`` changed), the data
   written by the port's ``data/synthetic.py`` with 20,000 users so the
   epoch outlasts the first save; the train process is killed with
   SIGKILL once a mid-epoch checkpoint is committed and run again:
   ``metrics.jsonl`` must show ``resumed_mid_epoch`` and an eval AUC in
   [0, 1].
20. b4r_jagged — the Bert4Rec CLI with a copy of ``configs/bert4rec.toml``
   (its widths; ``jagged = true``, ``attn = "flash"``, one epoch): flash
   launches n_layers per step in each backward kernel; then the jagged
   and the padded step from b4r_main's initial state on the same 3 ragged
   batches and dropout draws, losses within rtol 1e-4.

``--phases profile`` / ``profile_b4r`` / ``profile_dlrm`` /
``profile_bf16`` / ``profile_dlrm_bf16`` / ``profile_dense`` (not in the
default run) add a ``torch.profiler`` breakdown of steady TwoTower /
Bert4Rec / DLRM-Criteo / bf16 TwoTower / bf16 DLRM-Criteo main-path steps
and of the dense TwoTower's eager steps and CUDA-graph replays.

Output: the empty-kernel floor of each timing phase, a ``{"kernels":
[...]}`` JSON line (``ms``: CUDA events, ``device_ms``: profiler, the
median over ``device_records`` launches, every one recorded;
``library_device_ms``: the same for the library call), the
``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``.  Exits non-zero without a result when CUDA is absent or
the script stands outside the repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py:56-59 (the headline TwoTower DMP configuration)
SIZE_MAP = {
    "user": 500_000, "item": 200_000, "language": 32, "is_ebook": 2,
    "format": 16, "publisher": 5_000, "pub_decade": 16,
}
BATCH, DIM, LR, WD = 8192, 64, 3e-4, 1e-4
# config.toml's TwoTower quickstart: embed_dim 16 (adam: two rows a line),
# per_device_train_batch_size 2048
CONFIG_DIM, CONFIG_BATCH = 16, 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores, same sheet
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense, same sheet
ADAM_FLOP_PER_ELEMENT = 16  # mu 3, nu 4, 2 bias divides, sqrt, eps, divide, wd 2, lr, subtract
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")

# configs/bert4rec.toml at full width over bench.py::bench_serve_seq's
# catalogue (bench.py:1286)
B4R = dict(n_items=200_000, max_len=20, embed_dim=64, n_heads=2, n_layers=2,
           dropout=0.1)
B4R_BATCH, B4R_SEED, B4R_MASK_PROB = 256, 42, 0.2
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# 4, 6 and 8 B H T^2 Dh flops: QK^T and PV; dQ recomputes QK^T, dO V^T and
# adds dS K; dK/dV recomputes QK^T, dO V^T and adds P^T dO and dS^T Q
FLASH_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}

# DLRM-Criteo: bench.py:64-68's 26 Criteo-Kaggle vocabularies (33,762,577
# rows), the planner bench's defaults arm (bench.py:492-493, 346-349)
CRITEO_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)
CRITEO_CATS = tuple(f"cat_{i}" for i in range(26))
CRITEO_CONTS = tuple(f"cont_{i}" for i in range(13))
CRITEO_DIM, CRITEO_FUSED_MIN = 16, 16384  # tdfo_tpu/plan/planner.py:94
OOB = 2**31 - 1
# rowwise_adagrad per element: g + wd x (2), g^2 (1), sum (1), then
# x - lr g / denom (3) with g + wd x again (2); per row mean, sqrt, eps (3)
ROWWISE_FLOP_PER_ELEMENT, ROWWISE_FLOP_PER_ROW = 9, 3
# adagrad per element: g + wd x (2), acc + g^2 (2), lr g, sqrt, + eps,
# divide, subtract (5)
ADAGRAD_FLOP_PER_ELEMENT = 9
# DLRM-Criteo with bf16 storage: the reference refuses bf16 fused tables
# under the config's rowwise_adagrad (tdfo_tpu/parallel/embedding.py:307-315:
# the per-row accumulator is f32 by contract), so the bf16 fat stack
# trains with adagrad, whose per-element accumulator rides the bf16 line
# (the same [L, 1, 128] geometry at d = 16, R = 4)
DLRM_BF16_KIND = "adagrad"
_CSRC, _PK = "tdfo_tpu_torch/ops/csrc/", "tdfo_tpu/ops/pallas_kernels.py:"
KERNEL_TABLE = (  # name, source, the TPU kernel it replaces
    ("fat_line_update", _CSRC + "fat_line_update.cu", _PK + "885"),
    ("fat_line_update_routed", _CSRC + "fat_line_update_routed.cu", _PK + "1122"),
    ("flash_fwd", _CSRC + "flash_attn_fwd.cu", _PK + "73"),
    ("flash_bwd_dq", _CSRC + "flash_attn_bwd.cu", _PK + "222"),
    ("flash_bwd_dkv", _CSRC + "flash_attn_bwd.cu", _PK + "261"),
    # the bf16 branches of the two fat-line kernels (the TPU kernels'
    # _sr_writeback, pallas_kernels.py:841)
    ("fat_line_update[bf16]", _CSRC + "fat_line_update.cu", _PK + "885"),
    ("fat_line_update_routed[bf16]", _CSRC + "fat_line_update_routed.cu",
     _PK + "1122"),
)
DEFAULT_PHASES = ("build", "oracle", "timing", "main", "cli", "flash_oracle",
                  "flash_timing", "b4r_main", "b4r_cli", "routed_oracle",
                  "routed_timing", "dlrm_main", "dlrm_cli", "bf16_oracle",
                  "bf16_timing", "main_bf16", "dlrm_bf16_main", "dense_main",
                  "resume", "quickstart_cli", "b4r_jagged")


def say(*parts) -> None:
    print(*parts, flush=True)


def make_host_batch(rng: np.random.Generator, b: int) -> dict[str, np.ndarray]:
    """bench.py:90-102."""
    return {
        "user_id": rng.integers(0, SIZE_MAP["user"], b, dtype=np.int32),
        "item_id": rng.integers(0, SIZE_MAP["item"], b, dtype=np.int32),
        "language": rng.integers(0, SIZE_MAP["language"], b, dtype=np.int32),
        "is_ebook": rng.integers(0, 2, b, dtype=np.int32),
        "format": rng.integers(0, SIZE_MAP["format"], b, dtype=np.int32),
        "publisher": rng.integers(0, SIZE_MAP["publisher"], b, dtype=np.int32),
        "pub_decade": rng.integers(0, SIZE_MAP["pub_decade"], b, dtype=np.int32),
        "avg_rating": rng.random(b, dtype=np.float32),
        "num_pages": rng.random(b, dtype=np.float32),
        "label": rng.integers(0, 2, b).astype(np.float32),
    }


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def random_fat(torch, layout, rows, gen):
    """A fat table with random content in EVERY lane (pad lanes included,
    so a stray write shows); moment/accumulator lanes non-negative."""
    lines = layout.n_lines(rows)
    fat = torch.rand((lines, layout.tiles, 128), generator=gen,
                     device="cuda", dtype=torch.float32)
    view = fat.view(-1, layout.w)
    view[:, :layout.d] -= 0.5
    if layout.kind == "adam":
        view[:, layout.d:2 * layout.d] -= 0.5  # mu may be negative
    return fat


def touched_mask(torch, fat, ulines, touched, layout):
    """[L*R, W] bool: lanes [0, need) of every slot the step may write."""
    n_lines = fat.shape[0]
    mask = torch.zeros((n_lines * layout.r, layout.w), dtype=torch.bool,
                       device=fat.device)
    lines = ulines.to(torch.int64)
    ok = (lines >= 0) & (lines < n_lines)
    slots = (lines[:, None] * layout.r
             + torch.arange(layout.r, device=fat.device)).reshape(-1)
    keep = ok.repeat_interleave(layout.r)
    if touched is not None:
        keep &= touched.reshape(-1) > 0
    mask[slots[keep], :layout.need] = True
    return mask


def oracle_case(torch, kl, name, fat0, ulines, g, touched, corr, layout):
    """Kernel vs plain on clones of ``fat0``; returns max |err|."""
    from tdfo_tpu_torch.interop import TOL

    rtol, atol = TOL["optimizer"]
    kw = dict(layout=layout, lr=0.05, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=1e-2)
    a = fat0.clone()
    b = fat0.clone()
    kl.fat_line_update_plain(a, ulines, g, touched, corr, **kw)
    kl.fat_line_update(b, ulines, g, touched, corr, **kw)
    torch.cuda.synchronize()
    m = touched_mask(torch, fat0, ulines, touched, layout)
    va, vb, v0 = (t.view(-1, layout.w) for t in (a, b, fat0))
    if not torch.equal(vb[~m].view(torch.int32), v0[~m].view(torch.int32)):
        raise AssertionError(f"{name}: kernel changed untouched elements")
    if not torch.equal(va[~m].view(torch.int32), v0[~m].view(torch.int32)):
        raise AssertionError(f"{name}: plain version changed untouched elements")
    if not torch.isfinite(vb[m]).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(vb[m], va[m], rtol=rtol, atol=atol,
                               msg=lambda s: f"{name}: {s}")
    err = float((vb[m] - va[m]).abs().max()) if m.any() else 0.0
    n_touched = int(m.any(dim=1).sum())
    say(f"  {name}: touched rows {n_touched}, max_abs_err {err:.3e}, "
        f"bitwise-unchanged elements {int((~m).sum())}")
    return err


def phase_oracle(torch, rng) -> dict:
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    worst = 0.0
    for kind in KINDS:
        # d = 64 row form on a 500,000-row table, ~8,192 touched lines
        lay = line_layout(64, kind)
        if lay.r != 1:  # sgd/adagrad/rowwise pack several d=64 rows a line
            ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
            ul, seg, _ = sp.dedupe_ids(ids, vocab=500_000, rows_per_line=lay.r)
            c = ul.shape[0]
            g = sp._segment_sum(torch.randn((8192, 64), generator=gen, device="cuda"),
                                seg, c * lay.r).view(c, lay.r, 64)
            tl = (sp._segment_sum(torch.ones(8192, device="cuda"), seg, c * lay.r)
                  > 0).to(torch.float32).view(c, lay.r)
        else:
            ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
            ul, _, _ = sp.dedupe_ids(ids, vocab=500_000)
            g = torch.randn((ul.shape[0], 64), generator=gen, device="cuda")
            tl = None
        fat0 = random_fat(torch, lay, 500_000, gen)
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=64 R={lay.r}",
                                       fat0, ul, g, tl, corr, lay))
        del fat0
        # d = 16 packed form: several rows per line, a touched mask, some
        # padding ids (-1) that dedupe to the sentinel line
        lay = line_layout(16, kind)
        idn = rng.integers(0, 200_000, 8192)
        idn[rng.random(8192) < 0.02] = -1
        ids = torch.from_numpy(idn).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=200_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 16), generator=gen, device="cuda"),
                            seg, c * lay.r).view(c, lay.r, 16)
        tl = (sp._segment_sum((ids >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        fat0 = random_fat(torch, lay, 200_000, gen)
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=16 R={lay.r}",
                                       fat0, ul, g.contiguous(), tl, corr, lay))
        # sentinel, negative and out-of-range lines, untouched shared slots
        lay = line_layout(16, kind)
        fat0 = random_fat(torch, lay, 64 * lay.r, gen)
        ul = torch.tensor([3, 7, 2**31 - 1, 10, -5, 64, 11, 2**31 - 1],
                          dtype=torch.int32, device="cuda")
        g = torch.randn((8, lay.r, 16), generator=gen, device="cuda")
        tl = (torch.rand((8, lay.r), generator=gen, device="cuda") > 0.5
              ).to(torch.float32)
        tl[0] = 1.0
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=16 edge lines",
                                       fat0, ul, g, tl, corr, lay))
    say(f"oracle: fat_line_update passed, worst max_abs_err {worst:.3e}")
    return {"max_abs_err": worst}


def timed_ms(torch, fn, n, flush):
    """Mean CUDA-event time of ``fn`` over ``n`` launches, the 50 MB L2
    flushed (a 256 MB write) before each one."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def device_ms(torch, fn, n, flush, key=None, tries=4, per_call=False):
    """Median device duration per launch under ``torch.profiler`` (CUPTI's
    kernel start and end, no launch or event overhead) of the one kernel
    that each call of ``fn`` launches, whose name holds ``key`` (``None``:
    whatever ``fn`` launches), the L2 flushed before each call as in
    :func:`timed_ms`.  The ``n`` calls lie between two 4-byte host-to-device
    copies (markers on the device timeline), with one call more before and
    after them: the tracer has been seen to drop a kernel's record, and a
    record at the window's edge may go.  Every one of the ``n`` calls
    between the markers must have its record; a profile that lost any is
    taken again, up to ``tries`` times, and then the reading fails.  20 ms
    of host time pad the window at both ends.  With ``per_call`` (a library
    call that launches kernels of its own choosing) a marker precedes each
    call's flush instead, and a call's duration is the sum over every device
    operation between its marker and the next but the first, its flush;
    every call must show the same number of them.  Returns ``(ms,
    records)``."""
    from torch.profiler import ProfilerActivity, profile

    mark, one = torch.zeros(1, device="cuda"), torch.ones(1)

    def call():
        flush.zero_()
        fn()

    if per_call:
        return _device_ms_per_call(torch, call, n, mark, one, tries)
    misses = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            call()
            mark.copy_(one)
            for _ in range(n):
                call()
            mark.copy_(one)
            call()
            torch.cuda.synchronize()
            time.sleep(0.02)
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        marks = sorted(e.time_range.start for e in dev
                       if "Memcpy" in e.name and "HtoD" in e.name)
        ks = [e for e in dev if "FillFunctor" not in e.name
              and "Memcpy" not in e.name and (key is None or key in e.name)]
        inside = [e.time_range.elapsed_us() for e in ks if len(marks) == 2
                  and marks[0] < e.time_range.start < marks[1]]
        if len(inside) > n:  # one kernel per call
            raise AssertionError(f"device_ms: {len(inside)} kernels matching "
                                 f"{key!r} in {n} calls")
        if len(inside) == n:
            return float(np.median(inside)) / 1e3, n
        misses.append(f"{len(inside)} between {len(marks)} markers, "
                      f"{len(ks)} of {n + 2} in all")
    raise AssertionError(f"device_ms: records of the {n} calls of {key!r} "
                         f"missing in {tries} profiles: {misses}")


def _device_ms_per_call(torch, call, n, mark, one, tries):
    """:func:`device_ms` with ``per_call``: ``(median per-call ms, n)``."""
    from torch.profiler import ProfilerActivity, profile

    misses = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            call()
            for _ in range(n):
                mark.copy_(one)
                call()
            mark.copy_(one)
            call()
            torch.cuda.synchronize()
            time.sleep(0.02)
        dev = sorted((e for e in prof.events()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        marks = [e.time_range.start for e in dev
                 if "Memcpy" in e.name and "HtoD" in e.name]
        ops = [e for e in dev if not ("Memcpy" in e.name and "HtoD" in e.name)]
        calls = [[e for e in ops if a < e.time_range.start < b]
                 for a, b in zip(marks, marks[1:])]
        counts = {len(c) for c in calls}
        if (len(calls) == n and len(counts) == 1 and min(counts) > 1
                and all("FillFunctor" in c[0].name for c in calls)):
            return float(np.median([sum(e.time_range.elapsed_us() for e in c[1:])
                                    for c in calls])) / 1e3, n
        misses.append(f"{len(calls)} calls between {len(marks)} markers, "
                      f"device operations per call {sorted(counts)}")
    raise AssertionError(f"device_ms per call: {n} calls not all recorded "
                         f"alike in {tries} profiles: {misses}")


def device_readings(torch, fn, n, flush, key=None, most=4, per_call=False):
    """:func:`device_ms` readings, taken until the last two agree within
    25% (at most ``most``; a reading far off its neighbour has been seen
    once); fails if none do.  Returns ``(readings, records per reading)``:
    the value reported is the mean of the last two."""
    def read():
        return device_ms(torch, fn, n, flush, key, per_call=per_call)[0]

    reads = [read() for _ in range(2)]
    while max(reads[-2:]) > 1.25 * min(reads[-2:]):
        if len(reads) == most:
            raise AssertionError(f"device_ms of {key!r}: no two consecutive "
                                 f"readings agree within 25%: {reads} ms")
        reads.append(read())
    return reads, n


def launch_floor(torch, flush, n=50) -> dict:
    """The harness's floor: an empty kernel (``torch.cuda._sleep(0)``, a
    spin kernel of zero cycles) under :func:`timed_ms` and
    :func:`device_ms`."""
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    empty()
    dev, rec = device_ms(torch, empty, n, flush)
    floor = {"ms": timed_ms(torch, empty, n, flush), "device_ms": dev}
    say(f"  launch floor: empty kernel {floor['ms']:.6f} ms (CUDA events), "
        f"{dev:.6f} ms (profiler device duration, median of {rec}/{n} "
        f"records)")
    return floor


def time_in_turns(torch, run_k, run_p, n_k, n_p, flush, key):
    """Kernel and plain version in turns (kernel, plain, kernel, plain) with
    CUDA events, then the kernel's profiler device durations
    (:func:`device_readings`): ``(kernel ms list, plain ms list, device ms
    list, records per device reading)``."""
    ks, ps = [], []
    for _ in range(2):
        ks.append(timed_ms(torch, run_k, n_k, flush))
        ps.append(timed_ms(torch, run_p, n_p, flush))
    ds, rec = device_readings(torch, run_k, n_k, flush, key)
    return ks, ps, ds, rec


def phase_timing(torch, rng) -> dict:
    """Kernel and plain version at the main path's shape: the stacked
    user+item fat array (700,000 rows, d = 64 adam, R = 1) and one batch's
    deduplicated line ids (capacity 2 x 8192) — first held against each
    other on these operands, then timed."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    lay = line_layout(DIM, "adam")
    rows = SIZE_MAP["user"] + SIZE_MAP["item"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    fat = random_fat(torch, lay, rows, gen)
    ids = np.concatenate([rng.integers(0, SIZE_MAP["user"], BATCH),
                          SIZE_MAP["user"] + rng.integers(0, SIZE_MAP["item"], BATCH)])
    ul, _, valid = sp.dedupe_ids(torch.from_numpy(ids).cuda(), vocab=rows)
    g = torch.randn((ul.shape[0], DIM), generator=gen, device="cuda") * 1e-3
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    err = oracle_case(torch, kl, "adam d=64 main-path shape", fat, ul, g, None,
                      corr, lay)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    run_k = lambda: kl.fat_line_update(fat, ul, g, None, corr, **kw)  # noqa: E731
    run_p = lambda: kl.fat_line_update_plain(fat, ul, g, None, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_kernel")
    u_real = int(valid.sum())
    nbytes = u_real * (2 * 3 * DIM + DIM) * 4 + ul.shape[0] * 4 + 8
    flops = u_real * DIM * ADAM_FLOP_PER_ELEMENT
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ms, plain_ms = sum(ks) / len(ks), sum(ps) / len(ps)
    say(f"timing: fat_line_update at the main path's shape (adam d={DIM}, "
        f"{rows} rows, {u_real} touched lines of {ul.shape[0]} slots): "
        f"kernel {ks} ms (profiler device {ds} ms, medians of {rec}/50 "
        f"records), plain {ps} ms; bound "
        f"{bound:.6f} ms by {bound_by} "
        f"({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s = {bytes_ms:.6f} ms; "
        f"{flops} f32 flop at {F32_FLOP_PER_S / 1e12} TFLOP/s = {ops_ms:.6f} ms)")
    del fat
    torch.cuda.empty_cache()
    # the other shapes the kernel serves, from a stream of their own (the
    # shared one feeds the later phases)
    srng = np.random.default_rng(7)
    shapes = {"bert4rec": fat_timing_shape(
        torch, kl, f"timing: fat_line_update at the Bert4Rec shape (adam d={DIM}, "
        f"{B4R['n_items'] + 2} rows, one b4r_batch's lines)", lay,
        B4R["n_items"] + 2, b4r_batch(srng)["item"].reshape(-1), gen, flush, corr)}
    host = make_host_batch(srng, CONFIG_BATCH)
    ids = np.concatenate([host["user_id"], SIZE_MAP["user"] + host["item_id"]])
    shapes["config_packed"] = fat_timing_shape(
        torch, kl, f"timing: fat_line_update at config.toml's packed shape (adam "
        f"d={CONFIG_DIM} R=2, {rows} rows, B={CONFIG_BATCH})",
        line_layout(CONFIG_DIM, "adam"), rows, ids, gen, flush, corr)
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": sum(ds[-2:]) / 2,
            "device_records": rec, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "floor": floor, "shapes": shapes}


def fat_timing_shape(torch, kl, label, lay, rows, ids, gen, flush, corr) -> dict:
    """``fat_line_update`` (f32 adam) on a ``rows``-row table at one step's
    deduplicated ``ids`` (the packed form with its touched mask when a line
    holds several rows): held against the plain version, then timed as at
    the main path's shape beside its byte bound (each touched slot's table
    and moments read and written and its grad read; ``ulines`` and the mask
    read)."""
    from tdfo_tpu_torch.ops import sparse as sp

    fat = random_fat(torch, lay, rows, gen)
    idt = torch.from_numpy(ids).cuda()
    ul, seg, valid = sp.dedupe_ids(idt, vocab=rows, rows_per_line=lay.r)
    c = ul.shape[0]
    if lay.r == 1:
        g = torch.randn((c, lay.d), generator=gen, device="cuda") * 1e-3
        tl, n_touched = None, int(valid.sum())
    else:
        g = sp._segment_sum(torch.randn((idt.shape[0], lay.d), generator=gen,
                                        device="cuda") * 1e-3,
                            seg, c * lay.r).view(c, lay.r, lay.d)
        tl = (sp._segment_sum((idt >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        n_touched = int(tl.sum())
    err = oracle_case(torch, kl, label, fat, ul, g, tl, corr, lay)
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    run_k = lambda: kl.fat_line_update(fat, ul, g, tl, corr, **kw)  # noqa: E731
    run_p = lambda: kl.fat_line_update_plain(fat, ul, g, tl, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_kernel")
    per_row = (2 * 3 * lay.d + lay.d) * 4
    nbytes = n_touched * per_row + c * 4 + (0 if tl is None else c * lay.r * 4) + 8
    out = _bound_record(f"{label}, {n_touched} touched slots of {c * lay.r}",
                        ks, ps, ds, rec, nbytes,
                        n_touched * lay.d * ADAM_FLOP_PER_ELEMENT, per_row, err)
    del fat
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 3


def build_main_path(torch, device, tables0, backbone0):
    """The bench.py:510-631 library flow on ``device`` from the given
    initial tables / backbone (copied, never mutated)."""
    import copy

    from tdfo_tpu_torch.models.twotower import ctr_embedding_specs
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    step = make_sparse_train_step(coll, ctr_sparse_forward(backbone))
    return coll, state, step


def to_device(torch, host, device):
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def user_rows(coll, state, user_ids):
    from tdfo_tpu_torch.ops.fat_lines import fat_gather_rows

    aname, _, off = coll.resolve("user_id")
    return fat_gather_rows(state.tables[aname], user_ids + off,
                           coll.fat_layout_for(aname)).cpu()


def phase_main_path(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    # one initial state, made on the CPU from fixed seeds, for both runs
    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    fat_arrays = sorted(k for k, v in tables0.items() if v.dim() == 3)
    say(f"main path: arrays {sorted(tables0)}; fat {fat_arrays}")
    rng = np.random.default_rng(7)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    touched_users = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))

    coll, state, step = build_main_path(torch, "cuda", tables0, backbone0)
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    kl.fat_line_update.launches = 0
    losses = []
    t_start = None
    for i, b in enumerate(dev_batches):
        if i == check_steps:
            torch.cuda.synchronize()
            rows_gpu = user_rows(coll, state, touched_users.cuda())
            t_start = time.perf_counter()
        state, loss = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
    launches = kl.fat_line_update.launches
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = len(fat_arrays) * steps
    if launches != want:
        raise AssertionError(
            f"fat_line_update launched {launches} times in {steps} steps, "
            f"expected {want} ({len(fat_arrays)} fat array(s) x steps)")
    say(f"main path: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, fat_line_update launches {launches} "
        f"({launches // steps} per step), step_ms {step_ms:.4f} "
        f"(host clock over steps {check_steps + 1}-{steps}) on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the same first steps on the CPU path
    _, cstate, cstep = build_main_path(torch, "cpu", tables0, backbone0)
    closs = []
    for h in host[:check_steps]:
        cstate, loss = cstep(cstate, to_device(torch, h, "cpu"))
        closs.append(float(loss))
    rows_cpu = user_rows(coll, cstate, touched_users)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(losses[:check_steps], closs, rtol=rtol, atol=atol)
    torch.testing.assert_close(rows_gpu, rows_cpu, rtol=rtol, atol=atol)
    err = float((rows_gpu - rows_cpu).abs().max())
    say(f"main path: card vs CPU over {check_steps} steps: losses "
        f"{losses[:check_steps]} vs {closs}; {touched_users.numel()} touched "
        f"user rows, max_abs_err {err:.3e} (rtol {rtol})")
    return {"launches": launches, "step_ms": step_ms, "losses": losses}


def profile_steps(torch, name, state, step, batches, warm, *step_args) -> None:
    """``torch.profiler`` over the steady steps ``batches[warm:]``; prints
    device time by kernel and the device's busy share of the window (host
    clock)."""
    from torch.profiler import ProfilerActivity, profile

    for b in batches[:warm]:
        state, _ = step(state, b, *step_args)
    torch.cuda.synchronize()
    steps = len(batches) - warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[warm:]:
            state, _ = step(state, b, *step_args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    n_kernels = sum(e.count for e in events)
    say(f"profile {name}: {steps} steps, wall {wall_ms:.4f} ms "
        f"({wall_ms / steps:.4f} ms/step), device busy {dev_us / 1e3:.4f} ms "
        f"({100 * dev_us / 1e3 / wall_ms:.2f}% of the window), "
        f"{n_kernels / steps:.1f} device ops per step")
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    for e in top[:15]:
        say(f"  {getattr(e, 'self_device_time_total', 0.0) / steps:10.2f} us/step "
            f"x{e.count // steps:<4d} {e.key[:110]}")


def phase_profile(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile``): the TwoTower main path's steps."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cuda")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    _, state, step = build_main_path(torch, "cuda", tables0, backbone0)
    del tables0
    rng = np.random.default_rng(11)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "twotower", state, step, batches, warm)


# ---------------------------------------------------------------- phase 4


def phase_cli(torch) -> dict:
    """The TwoTower CLI journey, f32 storage and then bf16 storage
    (``[embeddings] table_dtype = "bfloat16"``: the packed d = 16, R = 2
    bf16 fat stack through ``fat_line_update``'s bf16 kernel; every table
    still bf16 after training)."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    out = {}
    for storage in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            cfg = tmp / "config.toml"
            cfg.write_text(
                f'data_dir = "{tmp / "data"}"\n'
                'model = "twotower"\nmodel_parallel = true\nembed_dim = 16\n'
                'fused_table_threshold = 0\nn_epochs = 1\n'
                'per_device_train_batch_size = 256\nper_device_eval_batch_size = 256\n'
                'log_every_n_steps = 4\n'
                f'[embeddings]\ntable_dtype = "{storage}"\n')
            for cmd in ("synth", "preprocess-ctr"):
                if launch.main([cmd, "--config", str(cfg)]) != 0:
                    raise AssertionError(f"launch {cmd} failed")
            kl.fat_line_update.launches = 0
            trainer = launch.run(["train", "--config", str(cfg), "--log-dir",
                                  str(tmp / "logs"), "--device", "cuda"])
            launches = kl.fat_line_update.launches
            recs = [json.loads(x) for x in
                    (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
        aucs = [r["auc"] for r in recs if "auc" in r]
        tr = [r for r in recs if "train_auc" in r]
        if not aucs or not (0.0 <= aucs[-1] <= 1.0) or not tr:
            raise AssertionError(f"metrics.jsonl lacks eval/train AUC: {recs}")
        if launches <= 0:
            raise AssertionError("CLI train never launched fat_line_update")
        dtypes = {str(t.dtype) for t in trainer.state.tables.values()}
        if dtypes != {f"torch.{storage}"}:
            raise AssertionError(f"{storage} CLI run ended with tables {dtypes}")
        say(f"cli ({storage} storage): synth -> preprocess-ctr -> train on the "
            f"card: eval auc {aucs[-1]:.4f}, train_auc {tr[-1]['train_auc']:.4f}, "
            f"fat_line_update launches {launches}, tables {sorted(dtypes)} after "
            "training")
        out[storage] = {"launches": launches, "auc": aucs[-1]}
    return out


# ---------------------------------------------------------------- phase 5


def flash_inputs(torch, dtype, b, h, t, dh, gen, masked_row=True):
    """q, k, v, dO on the card and a key mask: ~25% of keys masked at random
    (10% without ``masked_row``); with ``masked_row`` batch row 0 also has
    its first min(40, T/2) keys masked (a whole 32-key tile at T >= 80) and
    the last batch row has every key masked."""
    q, k, v, do = (torch.randn((b, h, t, dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    kv = torch.rand((b, t), generator=gen, device="cuda") > (
        0.25 if masked_row else 0.1)
    kv[:, -1] = True
    if masked_row:
        kv[0, :min(40, t // 2)] = False
        kv[-1] = False
    return q, k, v, do, kv


def flash_tol(torch, dtype, ref, f32_tol, floor=0.0):
    """``floor``: an absolute bf16 tolerance below the max-relative one, for
    cases whose exact result is 0 (a single key per row: dQ = 0 up to the
    rounding of ``dp - delta``), as the card tests' ``_flash_tol``."""
    if dtype == torch.float32:
        return dict(rtol=f32_tol, atol=f32_tol)
    return dict(rtol=2e-2, atol=2e-2 * float(ref.float().abs().max()) + floor)


def flash_check(torch, what, got, want, tol) -> float:
    """Kernel vs plain within ``tol`` (inf where the plain version has inf);
    returns the max |err| over the finite elements."""
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda s: f"{what}: {s}")
    fin = torch.isfinite(want)
    return float((got.float()[fin] - want.float()[fin]).abs().max()) if fin.any() else 0.0


def flash_against_plain(torch, fa, name, q, k, v, do, kv, masked_row,
                        floor=0.0) -> dict:
    """Each flash kernel against its plain version on the same operands
    (the backward pair gets the plain forward's lse and delta); returns the
    max |err| per kernel.  ``floor``: see :func:`flash_tol`."""
    f32 = q.dtype == torch.float32
    out, lse = fa.flash_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    out_inf, none = fa.flash_fwd(q, k, v, kv, with_lse=False)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    torch.cuda.synchronize()
    if none is not None or not torch.equal(out_inf, out):
        raise AssertionError(f"{name}: the inference forward differs")
    err = {"flash_fwd": max(
        flash_check(torch, f"{name} out", out, out_p,
                    flash_tol(torch, q.dtype, out_p, 2e-5)),
        flash_check(torch, f"{name} lse", lse, lse_p, dict(rtol=2e-5, atol=2e-5)))}
    delta = (do.float() * out_p.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, kv, lse_p, delta)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    err["flash_bwd_dq"] = flash_check(torch, f"{name} dq", dq, dq_p,
                                      flash_tol(torch, q.dtype, dq_p, 1e-4, floor))
    err["flash_bwd_dkv"] = max(
        flash_check(torch, f"{name} dk", dk, dk_p,
                    flash_tol(torch, q.dtype, dk_p, 1e-4, floor)),
        flash_check(torch, f"{name} dv", dv, dv_p,
                    flash_tol(torch, q.dtype, dv_p, 1e-4, floor)))
    if masked_row and not (bool((out[-1] == 0).all())
                           and bool(torch.isinf(lse[-1]).all())
                           and all(bool((x[-1] == 0).all()) for x in (dq, dk, dv))):
        raise AssertionError(f"{name}: the fully masked row is not 0 / +inf")
    say(f"  {name}: max_abs_err fwd {err['flash_fwd']:.3e} dq "
        f"{err['flash_bwd_dq']:.3e} dkv {err['flash_bwd_dkv']:.3e}"
        f"{' (f32)' if f32 else ' (bf16)'}")
    return err


def phase_flash_oracle(torch) -> dict:
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {dt: dict.fromkeys(FLASH_KERNELS, 0.0) for dt in ("f32", "bf16")}
    # B = 3, H = 3 at the tile edges of the three kernels (T = 1, 15-17,
    # 24, 25, 31, 33, 63-65, 127, 128, 257): 9 heads, not a multiple of the
    # heads one block packs; their gradients may be exactly 0 (T = 1), so
    # bf16 takes the card tests' absolute floor of 1e-6
    cases = [(2, 2, t, dh, 0.0) for t in (20, 100, 4096) for dh in (32, 64)]
    cases += [(3, 3, t, dh, 1e-6)
              for t in (1, 15, 16, 17, 24, 25, 31, 33, 63, 64, 65, 127, 128, 257)
              for dh in (32, 64)]
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for b, h, t, dh, floor in cases:
            ops = flash_inputs(torch, dtype, b, h, t, dh, gen)
            err = flash_against_plain(torch, fa, f"{dt} B={b} H={h} T={t} Dh={dh}",
                                      *ops, masked_row=True, floor=floor)
            for k, e in err.items():
                worst[dt][k] = max(worst[dt][k], e)
    say(f"flash_oracle: passed, worst max_abs_err {worst}")
    return worst


# ---------------------------------------------------------------- phase 6


def flash_bound(torch, name, b, h, t, dh, dtype):
    """(bound ms, "bytes" | "operations"): each input read once, each output
    written once (fwd: q, k, v, mask -> out, lse; dQ: q, k, v, dO, mask, lse,
    delta -> dQ; dK/dV: the same -> dK, dV), flops over the type's peak."""
    es = 2 if dtype == torch.bfloat16 else 4
    tensor = b * h * t * dh * es
    rows = b * h * t * 4
    nbytes = {"flash_fwd": 4 * tensor + b * t + rows,
              "flash_bwd_dq": 5 * tensor + b * t + 2 * rows,
              "flash_bwd_dkv": 6 * tensor + b * t + 2 * rows}[name]
    flops = FLASH_FLOPS[name] * b * h * t * t * dh
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def flash_timing_shape(torch, fa, label, b, h, t, dh, dtype, gen, n_k, n_p,
                       kv=None) -> dict:
    import torch.nn.functional as F

    q, k, v, do, kv_r = flash_inputs(torch, dtype, b, h, t, dh, gen,
                                     masked_row=False)
    kv = kv_r if kv is None else kv
    err = flash_against_plain(torch, fa, f"timing {label}", q, k, v, do, kv,
                              masked_row=False)
    out, lse = fa.flash_fwd(q, k, v, kv)
    delta = (do.float() * out.float()).sum(-1)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    mask = kv[:, None, None, :]
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, kv),
                      lambda: fa.flash_fwd_plain(q, k, v, kv),
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, kv, lse, delta),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, kv, lse, delta),
                         None),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, kv, lse, delta),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse, delta),
                          None),
    }
    lib_bwd = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,  # noqa: E731
                                          retain_graph=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for run_k, run_p, _ in fns.values():
        for _ in range(2):
            run_k()
            run_p()
    fns["flash_fwd"][2]()
    lib_bwd()
    lib_bwd_ms = [timed_ms(torch, lib_bwd, n_p, flush) for _ in range(2)]
    lib_dev = {"fwd": device_readings(torch, fns["flash_fwd"][2], n_k, flush,
                                      per_call=True)[0],
               "bwd": device_readings(torch, lib_bwd, n_k, flush, per_call=True)[0]}
    res = {"floor": launch_floor(torch, flush)}
    for name, (run_k, run_p, run_l) in fns.items():
        ks_, ps_, ls_ = [], [], []
        for _ in range(2):  # in turns: kernel, plain, library, kernel, ...
            ks_.append(timed_ms(torch, run_k, n_k, flush))
            ps_.append(timed_ms(torch, run_p, n_p, flush))
            if run_l is not None:
                ls_.append(timed_ms(torch, run_l, n_k, flush))
        ds_, rec = device_readings(torch, run_k, n_k, flush, name)
        bound, by = flash_bound(torch, name, b, h, t, dh, dtype)
        lib = ls_ if run_l is not None else lib_bwd_ms
        lds = lib_dev["fwd" if run_l is not None else "bwd"]
        res[name] = {"ms": sum(ks_) / 2, "plain_ms": sum(ps_) / 2,
                     "device_ms": sum(ds_[-2:]) / 2, "device_records": rec,
                     "library_ms": sum(lib) / 2,
                     "library_device_ms": sum(lds[-2:]) / 2,
                     "bound_ms": bound, "bound_by": by,
                     "max_abs_err": err[name]}
        say(f"flash_timing {label}: {name} kernel {ks_} ms (profiler device "
            f"{ds_} ms, medians of {rec}/{n_k} records), plain {ps_} ms, "
            f"library {lib} ms (profiler device {lds} ms, medians of "
            f"{n_k} calls' summed kernels) "
            f"({'SDPA forward' if run_l is not None else 'SDPA backward, dQ+dK+dV'}); "
            f"bound {bound:.6f} ms by {by} ({FLASH_FLOPS[name]} B H T^2 Dh = "
            f"{FLASH_FLOPS[name] * b * h * t * t * dh} flop)")
    del flush
    return res


def b4r_batch(rng, b: int = B4R_BATCH) -> dict[str, np.ndarray]:
    """A random Bert4Rec training batch: items in [1, n_items], 20% of
    positions replaced by the MASK id and labelled, and every fourth row
    short, PAD-padded at the tail (as preprocess-seq pads train windows) or
    on the left (as it pads eval windows)."""
    n, t = B4R["n_items"], B4R["max_len"]
    item = rng.integers(1, n + 1, (b, t)).astype(np.int32)
    masked = rng.random((b, t)) < B4R_MASK_PROB
    label = np.where(masked, item, 0).astype(np.int32)
    item = np.where(masked, n + 1, item).astype(np.int32)
    for r in range(0, b, 4):
        keep = int(rng.integers(2, t))
        cols = slice(keep, None) if r % 8 else slice(0, t - keep)
        item[r, cols] = 0
        label[r, cols] = 0
    return {"item": item, "label": label}


def phase_flash_timing(torch) -> dict:
    """The JSON line's numbers come from the main path's shape; the
    bench_kernels.py shapes are printed beside them."""
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, hh, t = B4R["embed_dim"], B4R["n_heads"], B4R["max_len"]
    kv = torch.from_numpy(b4r_batch(np.random.default_rng(5))["item"] != 0).cuda()
    main = flash_timing_shape(torch, fa, f"main path B={B4R_BATCH} H={hh} T={t} "
                              f"Dh={d // hh} f32", B4R_BATCH, hh, t, d // hh,
                              torch.float32, gen, 50, 20, kv=kv)
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        flash_timing_shape(torch, fa, f"bench_kernels B=1 H=8 T=4096 Dh=64 {dt}",
                           1, 8, 4096, 64, dtype, gen, 10, 5)
    return main


# ---------------------------------------------------------------- phase 7


def b4r_initial():
    """One initial state, made on the CPU from fixed seeds, for every run."""
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec

    return make_sharded_bert4rec(Bert4RecConfig(**B4R), seed=B4R_SEED,
                                 attn="flash", device="cpu")


def b4r_state(torch, coll, tables0, backbone0, device):
    """``(state, step)`` on ``device`` from copies of the initial state."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, bert4rec_sparse_forward(backbone))


def item_slots(coll, state, ids):
    """The whole slots (weights | adam mu | nu | pad) of item rows ``ids``."""
    from tdfo_tpu_torch.ops.fat_lines import fat_view

    aname, _, off = coll.resolve("item")
    table = state.tables[aname]
    if table.dim() != 3:
        raise AssertionError("the Bert4Rec item table is not fat")
    return fat_view(table, coll.fat_layout_for(aname))[ids + off].cpu()


def flash_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    return {"fat_line_update": kl.fat_line_update.launches,
            **{k: getattr(fa, k).launches for k in FLASH_KERNELS}}


def zero_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    kl.fat_line_update.launches = 0
    for k in FLASH_KERNELS:
        getattr(fa, k).launches = 0


def phase_b4r_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL

    coll, tables0, backbone0 = b4r_initial()
    n_layers = B4R["n_layers"]
    say(f"b4r_main: {B4R}, B {B4R_BATCH}, item array "
        f"{tuple(tables0['item_embedding'].shape)} (fat)")
    rng = np.random.default_rng(8)
    host = [b4r_batch(rng) for _ in range(steps)]
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    state, step = b4r_state(torch, coll, tables0, backbone0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(B4R_SEED + 1)
    torch.cuda.synchronize()
    zero_counts()
    losses = []
    t_start = None
    for i, b in enumerate(dev_batches):
        if i == check_steps:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        state, loss = step(state, b, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
    counts = flash_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": steps, **dict.fromkeys(FLASH_KERNELS, n_layers * steps)}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"b4r_main: {steps} steps on the card at dropout {B4R['dropout']}, losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, launches {counts} "
        f"({n_layers} per step of each flash kernel), step_ms {step_ms:.4f} "
        f"(host clock over steps {check_steps + 1}-{steps}), peak device "
        f"memory {peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the first steps at dropout 0 on the card and on the CPU path
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["item"].ravel() for h in host[:check_steps]])).astype(np.int64))
    runs = {}
    for device in ("cuda", "cpu"):
        st, stp = b4r_state(torch, coll, tables0, backbone0, device)
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, item_slots(coll, st, touched.to(device)))
        del st
    rtol, atol = TOL["trajectory"]
    d = B4R["embed_dim"]
    (lg, sg), (lc, sc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=rtol, atol=atol)
    # Adam divides each gradient element by its own magnitude, so where an
    # element's summed gradient lies inside the f32 noise of the two
    # devices' summation orders its step may take either sign: the weight
    # then moves by up to 2 lr per step.  At most 0.1% of the elements may
    # do so, each within that bound; every other one holds rtol 1e-4.
    rg, rc = sg[:, :d], sc[:, :d]
    diff = (rg - rc).abs()
    out = diff > atol + rtol * rc.abs()
    n_out, bound = int(out.sum()), 2 * LR * check_steps
    worst_out = float(diff[out].max()) if n_out else 0.0
    mu_g, mu_c = sg[:, d:2 * d], sc[:, d:2 * d]
    flips = int((torch.sign(mu_g[out]) != torch.sign(mu_c[out])).sum())
    say(f"b4r_main: card vs CPU over {check_steps} steps at dropout 0: losses "
        f"{lg} vs {lc}; {touched.numel()} touched item rows, "
        f"{rg.numel()} elements: max_abs_err {float(diff[~out].max()):.3e} "
        f"inside rtol {rtol}; {n_out} outside it, max |diff| {worst_out:.3e} "
        f"(bound {bound:.1e}), {flips} of them with the adam first moment of "
        f"opposite sign; median |mu| there "
        f"{float(mu_c.abs()[out].median()) if n_out else 0.0:.3e} vs "
        f"{float(mu_c.abs().median()):.3e} over all elements")
    if n_out > 1e-3 * rg.numel() or worst_out > bound:
        raise AssertionError(
            f"card vs CPU: {n_out} item-row elements outside rtol {rtol} "
            f"(max |diff| {worst_out}); at most {1e-3 * rg.numel():.0f} within "
            f"{bound} allowed")
    return {"launches": counts, "step_ms": step_ms, "losses": losses}


def phase_profile_b4r(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_b4r``): the Bert4Rec main path's steps."""
    coll, tables0, backbone0 = b4r_initial()
    state, step = b4r_state(torch, coll, tables0, backbone0, "cuda")
    rng = np.random.default_rng(12)
    batches = [to_device(torch, b4r_batch(rng), "cuda") for _ in range(warm + steps)]
    gen = torch.Generator(device="cuda").manual_seed(B4R_SEED + 1)
    profile_steps(torch, "bert4rec", state, step, batches, warm, gen)


# ---------------------------------------------------------------- phase 8


def phase_b4r_cli(torch) -> dict:
    from tdfo_tpu_torch import launch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = tmp / "config.toml"
        cfg.write_text(
            f'data_dir = "{tmp / "data"}"\n'
            'model = "bert4rec"\nattn = "flash"\nmodel_parallel = true\n'
            'embed_dim = 16\nfused_table_threshold = 0\nn_epochs = 1\n'
            'per_device_train_batch_size = 32\nper_device_eval_batch_size = 32\n'
            'log_every_n_steps = 4\n')
        for cmd in ("synth", "preprocess-seq"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_counts()
        rc = launch.main(["train", "--config", str(cfg), "--log-dir",
                          str(tmp / "logs"), "--device", "cuda"])
        counts = flash_counts()
        if rc != 0:
            raise AssertionError("launch train failed")
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    keys = [f"{m}@{k}" for k in (10, 20, 50) for m in ("Recall", "NDCG")]
    evals = [r for r in recs if all(k in r for k in keys)]
    tests = [r for r in recs if all(f"test_{k}" in r for k in keys)]
    vals = [r[k] for r in evals for k in keys] + [r[f"test_{k}"] for r in tests
                                                  for k in keys]
    if not evals or not tests or not all(0.0 <= x <= 1.0 for x in vals):
        raise AssertionError(f"metrics.jsonl lacks Recall/NDCG or test_*: {recs}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"CLI train left a kernel unlaunched: {counts}")
    say(f"b4r_cli: synth -> preprocess-seq -> train on the card: "
        f"{ {k: round(evals[-1][k], 4) for k in keys} }, test "
        f"{ {k: round(tests[-1]['test_' + k], 4) for k in keys} }, launches {counts}")
    return {"launches": counts}


# ------------------------------------------------------------ phases 9, 10


def routed_operands(torch, lay, rows, ids, gen, *, pad_rows=8):
    """One step's routed operands on a fat table of ``rows`` vocab rows:
    ``dedupe_rows_and_lines`` over ``ids`` with capacities as the dedup
    step sizes them (+ ``pad_rows`` padding row slots), the forward's line
    gather and random row grads (padding rows included: they must be
    ignored)."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.parallel.embedding import take_fill

    fat = random_fat(torch, lay, rows, gen)
    b = ids.shape[0]
    seg, ul, rl, rs = sp.dedupe_rows_and_lines(
        ids, capacity_rows=b + pad_rows, capacity_lines=b, rows_per_line=lay.r)
    lines = take_fill(fat, torch.where(ul < OOB, ul, 0)).contiguous()
    g_u = torch.randn((b + pad_rows, lay.d), generator=gen, device="cuda")
    return fat, lines, ul, rl, rs, g_u


def routed_case(torch, name, lay, fat0, lines, ul, rl, rs, g_u, corr) -> float:
    """Routed kernel vs its plain version (touched rows within the
    optimizer tolerance, everything else bitwise unchanged) and vs
    ``fat_line_update`` on the same update in slot space (bitwise).
    Clones of ``fat0``; returns the max |err| against the plain version."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    rtol, atol = TOL["optimizer"]
    kw = dict(layout=lay, lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    g_slots, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
    m = touched_mask(torch, fat0, ul, touched, lay)
    v0 = fat0.view(-1, lay.w).view(torch.int32)

    def untouched_changed(t):
        return bool(((t.view(-1, lay.w).view(torch.int32) != v0) & ~m).any())

    a = fat0.clone()
    kr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    if untouched_changed(a):
        raise AssertionError(f"{name}: plain version changed untouched elements")
    ref_touched = a.view(-1, lay.w)[m]
    del a
    b = fat0.clone()
    kr.fat_line_update_routed(b, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    vb = b.view(-1, lay.w)
    if untouched_changed(b):
        raise AssertionError(f"{name}: kernel changed untouched elements")
    if not torch.isfinite(vb[m]).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(vb[m], ref_touched, rtol=rtol, atol=atol,
                               msg=lambda s_: f"{name}: {s_}")
    err = float((vb[m] - ref_touched).abs().max()) if m.any() else 0.0
    c = fat0.clone()
    kl.fat_line_update(c, ul, g_slots, touched, corr, **kw)
    torch.cuda.synchronize()
    if not torch.equal(b.view(torch.int32), c.view(torch.int32)):
        raise AssertionError(f"{name}: routed kernel differs from fat_line_update")
    del b, c
    n_rows = int(m.any(dim=1).sum())
    shared = int((touched.sum(dim=1) > 1).sum())
    say(f"  {name}: touched rows {n_rows} ({shared} lines hold 2+ of them), "
        f"max_abs_err {err:.3e}, bitwise equal to fat_line_update, "
        f"bitwise-unchanged elements {int((~m).sum())}")
    return err


def criteo_fat_rows() -> int:
    return sum(v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN)


def phase_routed_oracle(torch, rng) -> dict:
    from tdfo_tpu_torch.ops.fat_lines import line_layout

    gen = torch.Generator(device="cuda").manual_seed(20)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    worst = 0.0
    cases = [(kind, 16, criteo_fat_rows() if kind == "rowwise_adagrad"
              else 2_000_000) for kind in KINDS]
    cases += [("rowwise_adagrad", 8, 2_000_000), ("adam", 64, 2_000_000)]
    for kind, d, rows in cases:
        lay = line_layout(d, kind)
        idn = rng.integers(0, rows, BATCH * 4)
        idn[rng.random(idn.shape[0]) < 0.01] = -1      # the sentinel row
        idn[1::97] = idn[::97][: idn[1::97].shape[0]] ^ 1  # neighbours share lines
        ids = torch.from_numpy(idn).cuda()
        fat, lines, ul, rl, rs, g_u = routed_operands(torch, lay, rows, ids, gen)
        worst = max(worst, routed_case(
            torch, f"{kind} d={d} R={lay.r} rows={rows}", lay, fat, lines, ul,
            rl, rs, g_u, corr))
        del fat, lines
        torch.cuda.empty_cache()
    # every touched line holding R touched rows (all slots of n lines), row
    # counts ragged against the rows per warp and the resident grid's rows
    # per pass (several passes), plus 5 padding rows
    for kind, d, n_lines in (("rowwise_adagrad", 16, 150_001),
                             ("adam", 32, 100_003), ("sgd", 8, 40_001)):
        lay = line_layout(d, kind)
        rows = (n_lines + 9) * lay.r
        ids = torch.from_numpy(rng.permutation(n_lines * lay.r)).cuda()
        fat, lines, ul, rl, rs, g_u = routed_operands(torch, lay, rows, ids, gen,
                                                      pad_rows=5)
        worst = max(worst, routed_case(
            torch, f"{kind} d={d} R={lay.r} full lines, {rl.shape[0]} row slots",
            lay, fat, lines, ul, rl, rs, g_u, corr))
        del fat, lines
    # hand-made edges: sentinel lines, a line past the table, padding rows
    lay = line_layout(16, "rowwise_adagrad")
    fat = random_fat(torch, lay, 64 * lay.r, gen)
    ul = torch.tensor([3, 7, 40, 70, OOB, OOB], dtype=torch.int32, device="cuda")
    rl = torch.tensor([0, 0, 0, 1, 2, 3, 4, 6, 6], dtype=torch.int32, device="cuda")
    rs = torch.tensor([0, 1, 3, 2, 1, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    lines = fat[torch.where(ul < 64, ul, 0).long()].contiguous()
    g_u = torch.randn((9, 16), generator=gen, device="cuda")
    worst = max(worst, routed_case(torch, "rowwise_adagrad d=16 edge lines", lay,
                                   fat, lines, ul, rl, rs, g_u, corr))
    say(f"routed_oracle: fat_line_update_routed passed, worst max_abs_err {worst:.3e}")
    return {"max_abs_err": worst}


def criteo_host_batch(rng: np.random.Generator, b: int = BATCH) -> dict:
    """bench.py:248-265 (uniform ids)."""
    out = {c: rng.integers(0, v, b, dtype=np.int32)
           for c, v in zip(CRITEO_CATS, CRITEO_VOCABS)}
    out.update({c: rng.random(b, dtype=np.float32) for c in CRITEO_CONTS})
    out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return out


def phase_routed_timing(torch, rng) -> dict:
    """The routed kernel at the DLRM main path's shape: one step's fat ids
    (the 8 big features x B, offsets into the stack, dedup capacities)."""
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    lay = line_layout(CRITEO_DIM, "rowwise_adagrad")
    rows = criteo_fat_rows()
    gen = torch.Generator(device="cuda").manual_seed(21)
    big = [v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN]
    offs = np.cumsum([0] + big[:-1])
    ids = np.concatenate([o + rng.integers(0, v, BATCH) for o, v in zip(offs, big)])
    fat, lines, ul, rl, rs, g_u = routed_operands(
        torch, lay, rows, torch.from_numpy(ids).cuda(), gen, pad_rows=0)
    g_u *= 1e-3
    corr = torch.zeros(2, device="cuda")
    err = routed_case(torch, "rowwise_adagrad main-path shape", lay, fat, lines,
                      ul, rl, rs, g_u, corr)
    kw = dict(layout=lay, lr=3e-4, eps=1e-8)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    run_k = lambda: kr.fat_line_update_routed(fat, lines, ul, rl, rs, g_u, corr, **kw)  # noqa: E731
    run_p = lambda: kr.fat_line_update_routed_plain(fat, lines, ul, rl, rs, g_u, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_routed")
    c = ul.shape[0]
    lidx = rl.to(torch.int64)
    line_of = torch.where(lidx < c, ul.to(torch.int64)[lidx.clamp(max=c - 1)], OOB)
    n_rows = int(((lidx < c) & (line_of < fat.shape[0])).sum())
    cr = rl.shape[0]
    # per updated row: the slot's need lanes read (from lines) and written,
    # its d grads read, row_lidx + row_slot + its ulines entry; every other
    # row slot reads its row_lidx; corr
    per_row = 2 * lay.need * 4 + lay.d * 4 + 12
    nbytes = n_rows * per_row + (cr - n_rows) * 4 + 8
    flops = n_rows * (lay.d * ROWWISE_FLOP_PER_ELEMENT + ROWWISE_FLOP_PER_ROW)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ms, plain_ms = sum(ks) / len(ks), sum(ps) / len(ps)
    say(f"routed_timing: fat_line_update_routed at the DLRM main path's shape "
        f"(rowwise_adagrad d={CRITEO_DIM} R={lay.r}, {rows} rows in "
        f"{fat.shape[0]} lines, {n_rows} updated rows of {cr} row slots, "
        f"{c} line slots): kernel {ks} ms (profiler device {ds} ms, medians "
        f"of {rec}/50 records), plain "
        f"{ps} ms; bound {bound:.6f} ms "
        f"by {bound_by} ({per_row} B per row, {nbytes} B at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s = {bytes_ms:.6f} ms; {flops} f32 flop "
        f"at {F32_FLOP_PER_S / 1e12} TFLOP/s = {ops_ms:.6f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": sum(ds[-2:]) / 2,
            "device_records": rec, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "floor": floor}


# ------------------------------------------------------------ phases 11, 12


def dlrm_initial(torch):
    """The main path's collection, initial tables (on the card) and
    backbone (on the CPU), from fixed seeds."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    coll = ShardedEmbeddingCollection(
        generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM, "row",
                                fused_threshold=CRITEO_FUSED_MIN),
        stack_tables=True, fused_kind="rowwise_adagrad")
    tables0 = coll.init(0, device="cuda")
    backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(1))
    return coll, tables0, backbone0


def dlrm_state(torch, coll, tables0, backbone0, device, kind="rowwise_adagrad"):
    """``(state, step)`` on ``device`` from copies of the initial state,
    the sparse optimizer ``kind`` (the config's rowwise_adagrad unless
    told)."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer(kind, lr=LR),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, ctr_sparse_forward(backbone),
                                         dedup_lookup=True)


def dlrm_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    return {"fat_line_update": kl.fat_line_update.launches,
            "fat_line_update_routed": kr.fat_line_update_routed.launches}


def zero_dlrm_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    kl.fat_line_update.launches = 0
    kr.fat_line_update_routed.launches = 0


def dlrm_touched_rows(torch, coll, state, host):
    """Each stack's touched rows ``[n, W]`` (fat: the whole slot, table and
    state; plain: the row and its accumulator), on the CPU."""
    from tdfo_tpu_torch.ops.fat_lines import fat_view

    out = {}
    for aname, table in state.tables.items():
        feats = [c for c in CRITEO_CATS if coll.resolve(c)[0] == aname]
        ids = np.unique(np.concatenate(
            [h[c].astype(np.int64) + coll.resolve(c)[2] for h in host for c in feats]))
        idx = torch.from_numpy(ids).to(table.device)
        if table.dim() == 3:
            out[aname] = fat_view(table, coll.fat_layout_for(aname))[idx].cpu()
        else:
            acc = state.slots[aname][0][idx]
            out[aname] = torch.cat([table[idx].float(),
                                    acc.view(idx.shape[0], -1).float()], dim=1).cpu()
    return out


def phase_dlrm_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL

    coll, tables0, backbone0 = dlrm_initial(torch)
    shapes = {k: tuple(v.shape) for k, v in tables0.items()}
    say(f"dlrm_main: arrays {shapes}, B {BATCH}, d {CRITEO_DIM}, "
        f"rowwise_adagrad lr {LR}, dense AdamW lr {LR} wd {WD}, dedup_lookup")
    rng = np.random.default_rng(9)
    host = [criteo_host_batch(rng) for _ in range(steps)]
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda")
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_dlrm_counts()
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = dlrm_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": 0, "fat_line_update_routed": steps}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"dlrm_main: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, launches {counts} (1 routed per step), step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}; {BATCH / step_ms * 1e3:.0f} "
        f"examples/s), peak device memory {peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the first steps on the card and on the CPU path from one initial state
    runs = {}
    for device in ("cuda", "cpu"):
        src = tables0 if device == "cuda" else {k: v.cpu() for k, v in tables0.items()}
        st, stp = dlrm_state(torch, coll, src, backbone0, device)
        del src
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, dlrm_touched_rows(torch, coll, st, host[:check_steps]))
        del st
        torch.cuda.empty_cache()
    rtol, atol = TOL["trajectory"]
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=rtol, atol=atol)
    parts = []
    for aname in rg:
        g, c = rg[aname], rc[aname]
        diff = (g - c).abs()
        out = int((diff > atol + rtol * c.abs()).sum())
        parts.append(f"{aname}: {g.shape[0]} touched rows, {g.numel()} elements, "
                     f"max_abs_err {float(diff.max()):.3e}, {out} outside rtol {rtol}")
        torch.testing.assert_close(g, c, rtol=rtol, atol=atol,
                                   msg=lambda s_, a=aname: f"{a}: {s_}")
    say(f"dlrm_main: card vs CPU over {check_steps} steps: losses {lg} vs {lc}; "
        + "; ".join(parts))
    return {"launches": counts, "step_ms": step_ms, "losses": losses}


def phase_profile_dlrm(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dlrm``): the DLRM-Criteo main path's steps."""
    coll, tables0, backbone0 = dlrm_initial(torch)
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda")
    del tables0
    rng = np.random.default_rng(13)
    batches = [to_device(torch, criteo_host_batch(rng), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dlrm-criteo", state, step, batches, warm)


def phase_dlrm_cli(torch) -> dict:
    from tdfo_tpu_torch import launch

    src = (ROOT / "configs" / "dlrm-criteo.toml").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        body = []
        for line in src.splitlines():
            if line.startswith("data_dir ="):
                line = f'data_dir = "{tmp / "data"}"'
            elif line.startswith("fused_table_threshold ="):
                line = "fused_table_threshold = 20"  # fat and plain stacks
            elif line.startswith("per_device_"):
                line = line.split("=")[0] + "= 256"
            body.append(line)
        cfg = tmp / "dlrm-criteo.toml"
        cfg.write_text("\n".join(body) + "\n")
        for cmd in ("synth-criteo", "preprocess-criteo"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_dlrm_counts()
        rc = launch.main(["train", "--config", str(cfg), "--log-dir",
                          str(tmp / "logs"), "--device", "cuda"])
        counts = dlrm_counts()
        if rc != 0:
            raise AssertionError("launch train failed")
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    aucs = [r["auc"] for r in recs if "auc" in r]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    if not aucs or not all(0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"metrics.jsonl lacks eval AUC: {recs}")
    if counts["fat_line_update_routed"] != steps or steps <= 0:
        raise AssertionError(f"routed launches {counts} for {steps} steps")
    say(f"dlrm_cli: synth-criteo -> preprocess-criteo -> train on the card "
        f"(configs/dlrm-criteo.toml, fused_table_threshold 20): eval auc "
        f"{[round(a, 4) for a in aucs]}, {steps} steps, launches {counts}")
    return {"launches": counts}


# ------------------------------------------------------- phases 13-16 (bf16)

# The card-vs-CPU check of the bf16 paths (main_bf16, dlrm_bf16_main).
# Both devices compute the backbone in bf16 but accumulate its products in
# other orders, so a gradient element may differ by a rounding or two;
# the table write that follows is the same function with the same random
# bits on both, so a touched element is bitwise equal unless its f32 value
# straddles a rounding boundary (one ulp apart) or its gradient element is
# so small that the noise moves the optimizer's normalised step (up to
# ``step_bound`` a step: lr for adam and adagrad, whose first step is
# lr sign(g)).  Held: the losses within BF16_LOSS_RTOL; at most
# BF16_FAR_SHARE of the touched table elements more than one bf16 ulp
# apart and none beyond one ulp + 2 step_bound per step; and, as a control
# that must fail, the same share between the initial rows and the CPU's
# (what a card path that wrote no row, or other rows, would leave).
# Readings (NVIDIA H100 80GB HBM3, 700.00 W): losses within 2.8e-6
# (TwoTower) and 1.5e-5 (DLRM) relative; beyond one ulp 0.52% of the user
# elements, 1.44% of the DLRM fat stack's, 1.25% of its plain stack's;
# the control 99.97%, 99.71% and 80.18%.
BF16_LOSS_RTOL = 2e-4
BF16_FAR_SHARE = 0.05
SR_SEED = 1234567


def bf16_ulps(torch, a, b):
    """Distance in bf16 steps between two bf16 tensors of one shape."""
    def order(t):
        x = t.view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(x >= 0x8000, -(x & 0x7FFF), x)
    return (order(a) - order(b)).abs()


def bf16_case(torch, name, lay, fat0, m, run_k, run_p, seed=SR_SEED):
    """One bf16 kernel against its plain version on the card, on clones of
    the bf16 table ``fat0``: ``run_k(fat, seed)`` / ``run_p(fat, seed)``
    update ``fat`` in place (f32 or bf16; seed None for f32).  ``m`` [L*R,
    W]: the lanes the step may write.  Every other element stays bitwise
    ``fat0``; the touched ones are bitwise the plain version's wherever the
    f32 kernel is bitwise the f32 plain version on the same (widened)
    operands, one bf16 ulp apart elsewhere; another seed changes the bits.
    Returns ``(kernel result, max |err|, one-ulp elements)``."""
    w = lay.w
    b16 = fat0.view(-1, w).view(torch.int16)
    k16, p16 = fat0.clone(), fat0.clone()
    run_k(k16, seed)
    run_p(p16, seed)
    torch.cuda.synchronize()
    for t, who in ((k16, "kernel"), (p16, "plain version")):
        if bool(((t.view(-1, w).view(torch.int16) != b16) & ~m).any()):
            raise AssertionError(f"{name}: the {who} changed untouched elements")
    kt, pt = k16.view(-1, w)[m], p16.view(-1, w)[m]
    del p16
    if not torch.isfinite(kt.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    f32 = {}
    for who, run in (("k", run_k), ("p", run_p)):
        t = fat0.float()
        run(t, None)
        torch.cuda.synchronize()
        f32[who] = t.view(-1, w)[m]
        del t
    same32 = f32["k"].view(torch.int32) == f32["p"].view(torch.int32)
    ulps = bf16_ulps(torch, kt, pt)
    n_ulp, n_f32 = int((ulps > 0).sum()), int((~same32).sum())
    if ulps.numel() and (int(ulps.max()) > 1 or bool((ulps[same32] > 0).any())):
        raise AssertionError(f"{name}: kernel vs plain {n_ulp} elements off, "
                             f"max {int(ulps.max())} ulp, {n_f32} f32 results differ")
    o16 = fat0.clone()
    run_k(o16, seed ^ 0x2545F49)
    torch.cuda.synchronize()
    if torch.equal(o16.view(-1, w)[m].view(torch.int16), kt.view(torch.int16)):
        raise AssertionError(f"{name}: another seed gave the same bits")
    del o16
    err = float((kt.float() - pt.float()).abs().max()) if kt.numel() else 0.0
    say(f"  {name}: {kt.numel()} touched elements, {n_ulp} one bf16 ulp from "
        f"the plain version ({n_f32} where the f32 kernel and plain version "
        f"differ), max_abs_err {err:.3e}, bitwise-unchanged elements "
        f"{int((~m).sum())}, another seed changes the bits")
    return k16, err, n_ulp


def phase_bf16_oracle(torch, rng) -> dict:
    """Both bf16 kernels against their plain versions (``bf16_case``): the 4
    kinds of ``fat_line_update`` at d = 64 on a 500,000-row table with
    ~8,192 lines (64 grid blocks) and packed at d = 16 with padding ids,
    plus sentinel / out-of-range lines and untouched shared slots; the
    routed kernel at d = 16 (R = 2-8), adagrad and rowwise on the full bf16
    Criteo stack, adam at d = 64 and the hand-made edge lines, each also bitwise
    ``fat_line_update`` given the routed grid's lines per block."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    gen = torch.Generator(device="cuda").manual_seed(30)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    kw = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    res = {"fat": [0.0, 0], "routed": [0.0, 0]}

    def fat_case(name, lay, rows, ul, g, tl):
        fat0 = random_fat(torch, lay, rows, gen).to(torch.bfloat16)
        m = touched_mask(torch, fat0, ul, tl, lay)
        run_k = lambda f, s: kl.fat_line_update(f, ul, g, tl, corr, layout=lay,  # noqa: E731
                                                sr_seed=s, **kw)
        run_p = lambda f, s: kl.fat_line_update_plain(f, ul, g, tl, corr,  # noqa: E731
                                                      layout=lay, sr_seed=s, **kw)
        _, err, n = bf16_case(torch, name, lay, fat0, m, run_k, run_p)
        res["fat"] = [max(res["fat"][0], err), res["fat"][1] + n]

    for kind in KINDS:
        lay = line_layout(64, kind, "bfloat16")
        ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=500_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 64), generator=gen, device="cuda"),
                            seg, c * lay.r)
        if lay.r == 1:
            g, tl = g.view(c, 64), None
        else:
            g = g.view(c, lay.r, 64)
            tl = (sp._segment_sum(torch.ones(8192, device="cuda"), seg, c * lay.r)
                  > 0).to(torch.float32).view(c, lay.r)
        fat_case(f"bf16 {kind} d=64 R={lay.r} ({c} line slots)", lay, 500_000,
                 ul, g, tl)
        lay = line_layout(16, kind, "bfloat16")
        idn = rng.integers(0, 200_000, 8192)
        idn[rng.random(8192) < 0.02] = -1
        ids = torch.from_numpy(idn).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=200_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 16), generator=gen, device="cuda"),
                            seg, c * lay.r).view(c, lay.r, 16).contiguous()
        tl = (sp._segment_sum((ids >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        fat_case(f"bf16 {kind} d=16 R={lay.r}", lay, 200_000, ul, g, tl)
        ul = torch.tensor([3, 7, OOB, 10, -5, 64, 11, OOB], dtype=torch.int32,
                          device="cuda")
        g = torch.randn((8, lay.r, 16), generator=gen, device="cuda")
        tl = (torch.rand((8, lay.r), generator=gen, device="cuda") > 0.5
              ).to(torch.float32)
        tl[0] = 1.0
        fat_case(f"bf16 {kind} d=16 edge lines", lay, 64 * lay.r, ul, g, tl)

    def routed_bf16(name, lay, fat32, ul, rl, rs, g_u):
        fat0 = fat32.to(torch.bfloat16)
        del fat32
        # the forward's gather: sentinel and out-of-range lines read line 0
        pick = torch.where((ul >= 0) & (ul < fat0.shape[0]), ul, 0).long()
        lines = {torch.bfloat16: fat0[pick].contiguous()}
        lines[torch.float32] = lines[torch.bfloat16].float()
        g_slots, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
        m = touched_mask(torch, fat0, ul, touched, lay)
        run_k = lambda f, s: kr.fat_line_update_routed(  # noqa: E731
            f, lines[f.dtype], ul, rl, rs, g_u, corr, layout=lay, sr_seed=s, **kw)
        run_p = lambda f, s: kr.fat_line_update_routed_plain(  # noqa: E731
            f, lines[f.dtype], ul, rl, rs, g_u, corr, layout=lay, sr_seed=s, **kw)
        k16, err, n = bf16_case(torch, name, lay, fat0, m, run_k, run_p)
        c = fat0.clone()
        kl.fat_line_update(c, ul, g_slots, touched, corr, layout=lay,
                           sr_seed=SR_SEED,
                           lines_per_step=kr.routed_lines_per_step(lay), **kw)
        torch.cuda.synchronize()
        if not torch.equal(k16.view(torch.int16), c.view(torch.int16)):
            raise AssertionError(f"{name}: routed kernel differs from "
                                 "fat_line_update at the routed grid's lps")
        res["routed"] = [max(res["routed"][0], err), res["routed"][1] + n]
        del k16, c, lines, fat0
        torch.cuda.empty_cache()

    cases = [(kind, 16, criteo_fat_rows() if kind in ("rowwise_adagrad",
                                                      DLRM_BF16_KIND)
              else 2_000_000) for kind in KINDS]
    cases += [("adam", 64, 2_000_000)]
    for kind, d, rows in cases:
        lay = line_layout(d, kind, "bfloat16")
        idn = rng.integers(0, rows, BATCH * 4)
        idn[rng.random(idn.shape[0]) < 0.01] = -1
        idn[1::97] = idn[::97][: idn[1::97].shape[0]] ^ 1
        fat32, _, ul, rl, rs, g_u = routed_operands(
            torch, line_layout(d, kind), rows, torch.from_numpy(idn).cuda(), gen)
        routed_bf16(f"bf16 routed {kind} d={d} R={lay.r} rows={rows}", lay,
                    fat32, ul, rl, rs, g_u)
    lay = line_layout(16, "rowwise_adagrad", "bfloat16")
    fat32 = random_fat(torch, lay, 64 * lay.r, gen)
    ul = torch.tensor([3, 7, 40, 70, OOB, OOB], dtype=torch.int32, device="cuda")
    rl = torch.tensor([0, 0, 0, 1, 2, 3, 4, 6, 6], dtype=torch.int32, device="cuda")
    rs = torch.tensor([0, 1, 3, 2, 1, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    g_u = torch.randn((9, 16), generator=gen, device="cuda")
    routed_bf16("bf16 routed rowwise_adagrad d=16 edge lines", lay, fat32, ul,
                rl, rs, g_u)
    say(f"bf16_oracle: passed; fat_line_update[bf16] max_abs_err "
        f"{res['fat'][0]:.3e}, {res['fat'][1]} one-ulp elements; "
        f"fat_line_update_routed[bf16] max_abs_err {res['routed'][0]:.3e}, "
        f"{res['routed'][1]} one-ulp elements")
    return res


def sr_ops(elements: int) -> int:
    """Integer operations of the stochastic-rounding writeback: the hash
    (2 multiply-adds, 3 shift-xors, 2 multiplies) and the rounding (mask,
    add, mask, shift), 13 per written element."""
    return 13 * elements


def phase_bf16_timing(torch, rng) -> dict:
    """Both bf16 kernels at their paths' shapes: ``fat_line_update`` on the
    TwoTower bf16 stack (700,000 rows, adam d = 64, R = 1) with one batch's
    deduplicated lines, the routed kernel on the bf16 Criteo stack with one
    DLRM step's routing; each held against its plain version on the same
    operands first, then timed like ``timing`` (L2 flushed, events, profiler
    device duration, empty-kernel floor) beside the byte bound."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    gen = torch.Generator(device="cuda").manual_seed(31)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {}
    # fat_line_update[bf16]: TwoTower
    lay = line_layout(DIM, "adam", "bfloat16")
    rows = SIZE_MAP["user"] + SIZE_MAP["item"]
    fat = random_fat(torch, lay, rows, gen).to(torch.bfloat16)
    ids = np.concatenate([rng.integers(0, SIZE_MAP["user"], BATCH),
                          SIZE_MAP["user"] + rng.integers(0, SIZE_MAP["item"], BATCH)])
    ul, _, valid = sp.dedupe_ids(torch.from_numpy(ids).cuda(), vocab=rows)
    g = torch.randn((ul.shape[0], DIM), generator=gen, device="cuda") * 1e-3
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    m = touched_mask(torch, fat, ul, None, lay)
    run_k = lambda f, s: kl.fat_line_update(f, ul, g, None, corr, sr_seed=s, **kw)  # noqa: E731
    run_p = lambda f, s: kl.fat_line_update_plain(f, ul, g, None, corr, sr_seed=s, **kw)  # noqa: E731
    _, err, _ = bf16_case(torch, "bf16 adam d=64 main-path shape", lay, fat, m,
                          run_k, run_p)
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, lambda: run_k(fat, SR_SEED),
                                    lambda: run_p(fat, SR_SEED), 50, 20, flush,
                                    "fat_line_update_kernel")
    u_real = int(valid.sum())
    per_row = 2 * lay.need * 2 + DIM * 4
    nbytes = u_real * per_row + ul.shape[0] * 4 + 8
    ops = u_real * (DIM * ADAM_FLOP_PER_ELEMENT) + sr_ops(u_real * lay.need)
    out["fat_line_update[bf16]"] = _bound_record(
        "bf16_timing: fat_line_update[bf16] at the TwoTower shape (adam "
        f"d={DIM}, {rows} rows, {u_real} touched lines of {ul.shape[0]} slots)",
        ks, ps, ds, rec, nbytes, ops, per_row, err)
    del fat, m
    torch.cuda.empty_cache()
    # fat_line_update_routed[bf16]: DLRM-Criteo
    lay32 = line_layout(CRITEO_DIM, DLRM_BF16_KIND)
    lay = line_layout(CRITEO_DIM, DLRM_BF16_KIND, "bfloat16")
    rows = criteo_fat_rows()
    big = [v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN]
    offs = np.cumsum([0] + big[:-1])
    ids = np.concatenate([o + rng.integers(0, v, BATCH) for o, v in zip(offs, big)])
    fat32, _, ul, rl, rs, g_u = routed_operands(
        torch, lay32, rows, torch.from_numpy(ids).cuda(), gen, pad_rows=0)
    fat = fat32.to(torch.bfloat16)
    del fat32
    g_u *= 1e-3
    corr = torch.zeros(2, device="cuda")
    kw = dict(layout=lay, lr=3e-4, eps=1e-8)
    lines = {torch.bfloat16: fat[torch.where(ul < OOB, ul, 0).long()].contiguous()}
    lines[torch.float32] = lines[torch.bfloat16].float()
    _, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
    m = touched_mask(torch, fat, ul, touched, lay)
    run_k = lambda f, s: kr.fat_line_update_routed(  # noqa: E731
        f, lines[f.dtype], ul, rl, rs, g_u, corr, sr_seed=s, **kw)
    run_p = lambda f, s: kr.fat_line_update_routed_plain(  # noqa: E731
        f, lines[f.dtype], ul, rl, rs, g_u, corr, sr_seed=s, **kw)
    _, err, _ = bf16_case(torch, f"bf16 {DLRM_BF16_KIND} main-path shape", lay,
                          fat, m, run_k, run_p)
    del m
    lines.pop(torch.float32)
    ks, ps, ds, rec = time_in_turns(torch, lambda: run_k(fat, SR_SEED),
                                    lambda: run_p(fat, SR_SEED), 50, 20, flush,
                                    "fat_line_update_routed")
    c, cr = ul.shape[0], rl.shape[0]
    lidx = rl.to(torch.int64)
    line_of = torch.where(lidx < c, ul.to(torch.int64)[lidx.clamp(max=c - 1)], OOB)
    n_rows = int(((lidx < c) & (line_of < fat.shape[0])).sum())
    per_row = 2 * lay.need * 2 + lay.d * 4 + 12
    nbytes = n_rows * per_row + (cr - n_rows) * 4 + 8
    ops = n_rows * lay.d * ADAGRAD_FLOP_PER_ELEMENT + sr_ops(n_rows * lay.need)
    out["fat_line_update_routed[bf16]"] = _bound_record(
        "bf16_timing: fat_line_update_routed[bf16] at the DLRM shape "
        f"({DLRM_BF16_KIND} d={CRITEO_DIM} R={lay.r}, {rows} rows in "
        f"{fat.shape[0]} lines, {n_rows} updated rows of {cr} row slots)",
        ks, ps, ds, rec, nbytes, ops, per_row, err)
    del fat, lines, flush
    torch.cuda.empty_cache()
    out["floor"] = floor
    return out


def _bound_record(label, ks, ps, ds, rec, nbytes, ops, per_row, err) -> dict:
    """Print one timing line and return its kernels-JSON numbers: the bound
    is the larger of the bytes over the HBM rate and the operations (f32
    flops and the rounding's integer operations) over the f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    say(f"{label}: kernel {ks} ms (profiler device {ds} ms, medians of "
        f"{rec}/50 records), plain {ps} ms; bound {bound:.6f} ms by {by} "
        f"({per_row} B per row, {nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s = "
        f"{bytes_ms:.6f} ms; {ops} operations at {F32_FLOP_PER_S / 1e12} "
        f"TOP/s = {ops_ms:.6f} ms)")
    return {"ms": sum(ks) / len(ks), "plain_ms": sum(ps) / len(ps),
            "device_ms": sum(ds[-2:]) / 2, "device_records": rec,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err}


def _bf16_specs(specs):
    import dataclasses

    import torch

    return [dataclasses.replace(s, dtype=torch.bfloat16) for s in specs]


def _check_bf16_rows(torch, name, g, c, base, step_bound, steps):
    """Card rows ``g`` vs CPU rows ``c`` after ``steps`` steps, and the
    initial rows ``base`` as the control (bf16 table lanes, [n, d]; the
    note at BF16_FAR_SHARE); returns a summary."""
    gf, cf = g.float(), c.float()
    ulp = torch.where(cf == 0, torch.full_like(cf, 2.0**-133),
                      torch.ldexp(torch.ones_like(cf),
                                  torch.frexp(cf.abs()).exponent - 8))
    diff = (gf - cf).abs()
    ceiling = ulp + 2 * step_bound * steps
    over = int((diff > ceiling).sum())
    ulps = bf16_ulps(torch, g, c)
    share = float((ulps > 1).double().mean())
    share0 = float((bf16_ulps(torch, base, c) > 1).double().mean())
    summary = (f"{name}: {g.shape[0]} touched rows, {g.numel()} elements: "
               f"{int((ulps == 0).sum())} bitwise equal, {int((ulps == 1).sum())} "
               f"one ulp apart, {int((ulps > 1).sum())} further ({share:.4%}, "
               f"at most {BF16_FAR_SHARE:.0%}; max |diff| {float(diff.max()):.3e}, "
               f"ceiling one ulp + {2 * step_bound * steps:.2e}); control, the "
               f"initial rows: {share0:.4%} further than one ulp")
    if over or share > BF16_FAR_SHARE:
        raise AssertionError(f"card vs CPU: {over} elements beyond the ceiling; "
                             + summary)
    if share0 <= BF16_FAR_SHARE:
        raise AssertionError(f"card vs CPU: the control passes, so the check "
                             f"cannot fail; {summary}")
    return summary


def twotower_bf16_initial(torch):
    """Path 1's collection (every spec bf16), initial tables (on the CPU)
    and bf16-compute backbone, from fixed seeds."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    coll = ShardedEmbeddingCollection(_bf16_specs(ctr_embedding_specs(SIZE_MAP, DIM, "row")))
    tables0 = coll.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1),
                                 dtype=torch.bfloat16)
    return coll, tables0, backbone0


def twotower_bf16_state(torch, coll, tables0, backbone0, device):
    """``(state, step)`` of path 1 on ``device`` from copies of the initial
    state: sparse adam with the bench's f32 slots, dense AdamW."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState, make_sparse_train_step

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, ctr_sparse_forward(backbone))


def phase_main_bf16(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Path 1: ``bench.py::build_sparse_train_bench(8192, 64,
    table_dtype="bfloat16")`` (``bench.py:511-551``): every table bf16 (the
    user+item fat stack with its adam state in the line; the five small
    tables bf16 with f32 mu/nu, the bench's slot dtype), stochastically
    rounded writes, the backbone computing in bf16 as the bench does on a
    chip (``bench.py:534-535``)."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    coll, tables0, backbone0 = twotower_bf16_initial(torch)
    fat_arrays = sorted(k for k, v in tables0.items() if v.dim() == 3)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()}
    say(f"main_bf16: arrays {shapes}; fat {fat_arrays}")

    def build(device):
        return twotower_bf16_state(torch, coll, tables0, backbone0, device)

    rng = np.random.default_rng(17)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    state, step = build("cuda")
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.fat_line_update.launches = 0
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = kl.fat_line_update.launches
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    if launches != len(fat_arrays) * steps or len(fat_arrays) != 1:
        raise AssertionError(f"fat_line_update launched {launches} times in "
                             f"{steps} steps, expected one per step")
    if any(t.dtype != torch.bfloat16 for t in state.tables.values()):
        raise AssertionError("a table left bf16 storage")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"main_bf16: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, fat_line_update launches {launches} (1 per step), "
        f"the fat array still {state.tables[fat_arrays[0]].dtype}, step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}), peak device memory "
        f"{peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    runs = {}
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))
    for device in ("cuda", "cpu"):
        st, stp = build(device)
        if device == "cpu":
            base = user_rows(coll, st, touched)
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, user_rows(coll, st, touched.to(device)))
        del st
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
    summary = _check_bf16_rows(torch, "user rows", rg.to(torch.bfloat16),
                               rc.to(torch.bfloat16), base.to(torch.bfloat16),
                               LR, check_steps)
    say(f"main_bf16: card vs CPU over {check_steps} steps (bf16 compute): "
        f"losses {lg} vs {lc} (rtol {BF16_LOSS_RTOL}); {summary}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "losses": losses}


def dlrm_bf16_initial(torch):
    """Path 2's collection (every spec bf16), initial tables (on the card)
    and bf16-compute backbone, from fixed seeds."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    coll = ShardedEmbeddingCollection(
        _bf16_specs(generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM, "row",
                                            fused_threshold=CRITEO_FUSED_MIN)),
        stack_tables=True, fused_kind=DLRM_BF16_KIND)
    tables0 = coll.init(0, device="cuda")
    backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.bfloat16)
    return coll, tables0, backbone0


def phase_dlrm_bf16_main(torch, card: str, steps: int = 20,
                         check_steps: int = 3) -> dict:
    """Path 2: phase 11's DLRM-Criteo flow with ``table_dtype =
    "bfloat16"`` (``configs/dlrm-criteo.toml:66-67``) and the sparse
    optimizer ``DLRM_BF16_KIND`` (its note): the 8 big tables in one bf16
    adagrad fat stack ``[8,428,795, 1, 128]`` (2.16 GB, the accumulator
    lanes bf16 too), the 18 others in one bf16 plain stack (f32
    accumulators), ``dedup_lookup``, the backbone computing in bf16 as the
    bench (``bench.py:306``)."""
    coll, tables0, backbone0 = dlrm_bf16_initial(torch)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()}
    say(f"dlrm_bf16_main: arrays {shapes}, B {BATCH}, d {CRITEO_DIM}, "
        f"{DLRM_BF16_KIND} lr {LR}, dense AdamW lr {LR} wd {WD}, dedup_lookup, "
        "bf16 compute")
    rng = np.random.default_rng(19)
    host = [criteo_host_batch(rng) for _ in range(steps)]
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda",
                             DLRM_BF16_KIND)
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_dlrm_counts()
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = dlrm_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": 0, "fat_line_update_routed": steps}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    if any(t.dtype != torch.bfloat16 for t in state.tables.values()):
        raise AssertionError("a table left bf16 storage")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"dlrm_bf16_main: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, launches {counts} (1 routed per step), step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}; "
        f"{BATCH / step_ms * 1e3:.0f} examples/s), peak device memory "
        f"{peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    runs = {}
    for device in ("cuda", "cpu"):
        src = tables0 if device == "cuda" else {k: v.cpu() for k, v in tables0.items()}
        st, stp = dlrm_state(torch, coll, src, backbone0, device, DLRM_BF16_KIND)
        del src
        if device == "cpu":
            base = dlrm_touched_rows(torch, coll, st, host[:check_steps])
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, dlrm_touched_rows(torch, coll, st, host[:check_steps]))
        del st
        torch.cuda.empty_cache()
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
    parts = [_check_bf16_rows(torch, aname,
                              rg[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              rc[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              base[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              LR, check_steps) for aname in rg]
    say(f"dlrm_bf16_main: card vs CPU over {check_steps} steps (bf16 compute): "
        f"losses {lg} vs {lc} (rtol {BF16_LOSS_RTOL}); " + "; ".join(parts))
    return {"launches": counts, "step_ms": step_ms, "peak_gb": peak_gb,
            "losses": losses}


def phase_profile_bf16(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_bf16``): path 1's (TwoTower, bf16
    storage and compute) steps."""
    coll, tables0, backbone0 = twotower_bf16_initial(torch)
    state, step = twotower_bf16_state(torch, coll, tables0, backbone0, "cuda")
    del tables0
    rng = np.random.default_rng(11)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "twotower bf16", state, step, batches, warm)


def phase_profile_dlrm_bf16(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dlrm_bf16``): path 2's steps."""
    coll, tables0, backbone0 = dlrm_bf16_initial(torch)
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda",
                             DLRM_BF16_KIND)
    del tables0
    rng = np.random.default_rng(13)
    batches = [to_device(torch, criteo_host_batch(rng), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dlrm-criteo bf16", state, step, batches, warm)


# ---------------------------------------------------------- phases 17-20

# steps_per_execution of the dense phase's CUDA-graph run
DENSE_SPE = 4
# quickstart_cli: synthetic users (about 247 train batches of 2048 in the
# one epoch, so the epoch outlasts the first mid-epoch save) and the save
# cadence
QS_USERS, QS_CKPT_EVERY = 20_000, 20


def state_tensors(tree, prefix=""):
    """``{"a/b/0": tensor}`` of a state's tensor-dict form."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in state_tensors(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return state_tensors(dict(enumerate(tree)), prefix)
    return {prefix.rstrip("/"): tree}


def state_diff(torch, a, b) -> float:
    """Largest |a - b| over two states' tensor-dict forms (0.0 when bitwise
    equal, inf when a key, dtype or ``step`` differs)."""
    fa, fb = state_tensors(a), state_tensors(b)
    if fa.keys() != fb.keys():
        return float("inf")
    worst = 0.0
    for k, x in fa.items():
        y = fb[k]
        if not isinstance(x, torch.Tensor):
            if x != y:
                return float("inf")
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return float("inf")
        if torch.equal(x, y.to(x.device)):
            continue
        d = (x.double() - y.to(x.device).double()).abs()
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


def cpu_copy(torch, tree):
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_tensors(tree).items()}


# uninterrupted runs a resumed (or graph-replayed) run is held against
N_REFS = 3


def spread_check(torch, name, refs, run, what) -> str:
    """``run`` = ``(losses, state_dict)`` against ``refs``, the same steps
    run uninterrupted ``N_REFS`` times.  The spread S is the largest
    difference between two refs over every loss and state element; when S
    is 0 (the uninterrupted run repeats itself bitwise) ``run`` must equal
    them bitwise, else every element of ``run`` must lie within the refs'
    range widened by S.  Returns the printed line; raises otherwise."""
    flat = [dict(state_tensors(sd), losses=ls) for ls, sd in refs]
    mine = dict(state_tensors(run[1]), losses=run[0])
    if any(f.keys() != mine.keys() for f in flat):
        raise AssertionError(f"{name}: the runs' states have other keys")

    def bounds(k):
        st = torch.stack([f[k].to(mine[k].device).double() for f in flat])
        return st.min(0).values, st.max(0).values

    spread = 0.0
    for k, x in mine.items():
        if not isinstance(x, torch.Tensor):
            if any(f[k] != x for f in flat):
                raise AssertionError(f"{name}: {k} differs: {x} vs {[f[k] for f in flat]}")
            continue
        lo, hi = bounds(k)
        spread = max(spread, float((hi - lo).max()))
    outside, worst, near = 0, 0.0, 0.0
    for k, x in mine.items():
        if not isinstance(x, torch.Tensor):
            continue
        lo, hi = bounds(k)
        xd = x.double()
        over = torch.maximum(lo - xd, xd - hi).clamp_min(0.0)
        outside += int((over > spread).sum())
        worst = max(worst, float(over.max()))
        near = max(near, float((xd - flat[0][k].to(x.device).double()).abs().max()))
    rule = ("bitwise (the uninterrupted runs agree bitwise)" if spread == 0.0
            else f"inside the refs' range widened by the spread {spread:.3e}")
    line = (f"{name}: {what}: {len(flat)} uninterrupted runs, spread {spread:.3e}; "
            f"max |R - ref 0| {near:.3e}, furthest outside the refs' range "
            f"{worst:.3e}, {outside} elements beyond the spread; rule: {rule}")
    if outside:
        raise AssertionError(line)
    return line


def dense_initial(torch):
    """One dense ``TwoTower`` at bench.py::build_train_bench's width
    (SIZE_MAP, d = 64, f32), on the CPU from a fixed seed."""
    from tdfo_tpu_torch.models.twotower import init_twotower

    return init_twotower(0, SIZE_MAP, DIM, device="cpu")


def dense_state(torch, model0, device):
    """A fresh ``TrainState`` on ``device`` from a copy of ``model0``
    (AdamW lr 3e-4 wd 1e-4; capturable on the card)."""
    import copy

    from tdfo_tpu_torch.train.state import TrainState

    return TrainState.create(model=copy.deepcopy(model0).to(device),
                             learning_rate=LR, weight_decay=WD,
                             capturable=device == "cuda")


def dense_user_rows(state, ids):
    return state.model.user_embed.weight.detach()[ids].cpu()


def phase_dense_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Phase 17: the dense TwoTower (``model_parallel = false``) at
    ``bench.py::build_train_bench``'s width, eager and as CUDA-graph
    replays; card vs CPU; a checkpoint round trip of the capturable state."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager
    from tdfo_tpu_torch.train.step import (
        CudaGraphStep,
        make_multi_step,
        make_train_step,
    )

    model0 = dense_initial(torch)
    n_params = sum(p.numel() for p in model0.parameters())
    say(f"dense_main: TwoTower {SIZE_MAP}, d {DIM}, {n_params} parameters "
        f"(every one under AdamW), B {BATCH}, f32")
    rng = np.random.default_rng(21)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    dev = [to_device(torch, h, "cuda") for h in host]
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))

    def eager():
        state = dense_state(torch, model0, "cuda")
        step = make_train_step()
        torch.cuda.synchronize()
        losses, rows, t_start = [], None, None
        for i, b in enumerate(dev):
            if i == check_steps:
                torch.cuda.synchronize()
                rows = dense_user_rows(state, touched.cuda())
                t_start = time.perf_counter()
            state, loss = step(state, b)
            losses.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
        return state, torch.stack(losses).cpu(), rows, ms

    refs, times, rows_gpu = [], [], None
    for i in range(N_REFS):
        st, ls, rows, ms = eager()
        if i == 0:
            rows_gpu, la = rows, ls
        refs.append((ls, st.state_dict()))
        times.append(ms)
        del st
    if not torch.isfinite(la).all():
        raise AssertionError(f"non-finite losses: {la.tolist()}")
    eager_ms = times[0]
    say(f"dense_main: {steps} eager steps on the card, {N_REFS} runs, losses "
        f"{float(la[0]):.6f} -> {float(la[-1]):.6f}, step_ms "
        f"{', '.join(f'{t:.4f}' for t in times)} (host clock over steps "
        f"{check_steps + 1}-{steps}), on {card}")

    # steps_per_execution = DENSE_SPE: each step of a chunk is one replay
    sg = dense_state(torch, model0, "cuda")
    graphed = CudaGraphStep(make_train_step())
    multi = make_multi_step(graphed)
    chunks = [{k: torch.stack([b[k] for b in dev[i:i + DENSE_SPE]]) for k in dev[0]}
              for i in range(0, steps, DENSE_SPE)]
    torch.cuda.synchronize()
    lg, t_start = [], None
    for j, c in enumerate(chunks):
        if j == 1:  # the first chunk holds the warm-up and the capture
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        sg, losses = multi(sg, c)
        lg.append(losses)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t_start) * 1e3 / (steps - DENSE_SPE)
    lg = torch.cat(lg).cpu()
    if sg.step != steps:
        raise AssertionError(f"graph run counted {sg.step} steps, ran {steps}")
    say(spread_check(torch, "dense_main", refs, (lg, sg.state_dict()),
                     f"CUDA-graph run (steps_per_execution {DENSE_SPE}) vs "
                     "eager, losses and final state"))
    del refs
    say(f"dense_main: eager step_ms {eager_ms:.4f} vs CUDA-graph replay "
        f"step_ms {graph_ms:.4f} (host clock over steps {DENSE_SPE + 1}-"
        f"{steps}) on {card}")

    # the capturable state through a checkpoint, into both forms
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(steps, sg)
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in Path(tmp).rglob("*") if p.is_file())
        for device in ("cuda", "cpu"):
            fresh = dense_state(torch, model0, device)
            t0 = time.perf_counter()
            mgr.restore(fresh)
            if device == "cuda":
                torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            d = state_diff(torch, fresh.state_dict(), sg.state_dict())
            if d != 0.0:
                raise AssertionError(f"dense checkpoint restored into {device} "
                                     f"differs from the saved state by {d}")
            say(f"dense_main: checkpoint of the capturable state: {nbytes} bytes, "
                f"save {save_s:.3f} s, restore into a {device} state "
                f"{restore_s:.3f} s, bitwise equal (AdamW step counter on "
                f"{fresh.optimizer.state[next(fresh.model.parameters())]['step'].device})")
            del fresh
    del sg, graphed, multi, chunks
    torch.cuda.empty_cache()

    # the first steps on the port's CPU path from the same initial model
    cs, step = dense_state(torch, model0, "cpu"), make_train_step()
    closs = []
    for h in host[:check_steps]:
        cs, loss = step(cs, to_device(torch, h, "cpu"))
        closs.append(float(loss))
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(la[:check_steps].numpy(), closs, rtol=rtol, atol=atol)
    rows_cpu = dense_user_rows(cs, touched)
    torch.testing.assert_close(rows_gpu, rows_cpu, rtol=rtol, atol=atol)
    say(f"dense_main: card vs CPU over {check_steps} steps: losses "
        f"{la[:check_steps].tolist()} vs {closs}; {touched.numel()} touched user "
        f"rows, max_abs_err {float((rows_gpu - rows_cpu).abs().max()):.3e} "
        f"(rtol {rtol})")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms}


def phase_profile_dense(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dense``): the dense TwoTower's eager
    steps, then its CUDA-graph replays."""
    from tdfo_tpu_torch.train.step import CudaGraphStep, make_train_step

    model0 = dense_initial(torch)
    rng = np.random.default_rng(14)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dense twotower eager", dense_state(torch, model0, "cuda"),
                  make_train_step(), batches, warm)
    profile_steps(torch, "dense twotower CUDA-graph replays",
                  dense_state(torch, model0, "cuda"),
                  CudaGraphStep(make_train_step()), batches, warm)


def resume_setups(torch):
    """``(name, make_state, batches, step_args, expected launches per
    step)`` of the resume phase: phases 3, 15 and 7's setups at their
    widths, each state built fresh from one initial state."""
    from tdfo_tpu_torch.train.seq import dropout_generator

    coll, tables0, backbone0 = b4r_initial()
    two = ShardedTwoTower(torch)
    bf = twotower_bf16_initial(torch)
    return [
        ("main", lambda: two.state(), lambda rng: make_host_batch(rng, BATCH),
         lambda st: (), {"fat_line_update": 1}),
        ("main_bf16", lambda: twotower_bf16_state(torch, *bf, "cuda"),
         lambda rng: make_host_batch(rng, BATCH), lambda st: (),
         {"fat_line_update": 1}),
        ("b4r_main", lambda: b4r_state(torch, coll, tables0, backbone0, "cuda"),
         b4r_batch,
         lambda st: (dropout_generator(B4R_SEED + 1, st.step, "cuda"),),
         {"fat_line_update": 1,
          **dict.fromkeys(FLASH_KERNELS, B4R["n_layers"])}),
    ]


class ShardedTwoTower:
    """Phase 3's initial state, kept on the CPU, for fresh card states."""

    def __init__(self, torch):
        from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
        from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

        self.torch = torch
        self.coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
        self.tables0 = self.coll.init(0, device="cpu")
        self.backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))

    def state(self):
        _, state, step = build_main_path(self.torch, "cuda", self.tables0,
                                         self.backbone0)
        return state, step


def phase_resume(torch, card: str, steps: int = 20, cut: int = 10) -> dict:
    """Phase 18: for each setup, ``steps`` uninterrupted steps ``N_REFS``
    times, then a run R that trains ``cut`` steps, saves, restores into a
    fresh state (bitwise the saved one) and trains the rest; R against the
    uninterrupted runs by :func:`spread_check`; every run launches each
    kernel of its path the expected times per step."""
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    counts_of = {"fat_line_update": lambda c: c["fat_line_update"],
                 **{k: (lambda c, k=k: c[k]) for k in FLASH_KERNELS}}
    out = {}
    for name, make, batch_fn, args_fn, per_step in resume_setups(torch):
        rng = np.random.default_rng(31)
        dev = [to_device(torch, batch_fn(rng), "cuda") for _ in range(steps)]

        def run(state, step, batches):
            losses = []
            for b in batches:
                state, loss = step(state, b, *args_fn(state))
                losses.append(loss)
            return state, losses

        def check_counts(what, n):
            counts = flash_counts()
            want = {k: v * n for k, v in per_step.items()}
            got = {k: counts_of[k](counts) for k in want}
            if got != want:
                raise AssertionError(f"resume {name} {what}: launches {got}, "
                                     f"expected {want}")
            return got

        refs = []
        for _ in range(N_REFS):
            state, step = make()
            zero_counts()
            state, losses = run(state, step, dev)
            torch.cuda.synchronize()
            check_counts("uninterrupted run", steps)
            refs.append((torch.stack(losses).cpu(), state.state_dict()))
            del state, step
        # R: cut, save, restore into a fresh state, the rest
        with tempfile.TemporaryDirectory() as tmp:
            state, step = make()
            zero_counts()
            state, l1 = run(state, step, dev[:cut])
            torch.cuda.synchronize()
            mgr = CheckpointManager(tmp)
            t0 = time.perf_counter()
            mgr.save(cut, state, cursor={"epoch": 0, "step": cut,
                                         "epoch_complete": False,
                                         "global_step": cut})
            save_s = time.perf_counter() - t0
            nbytes = sum(p.stat().st_size for p in Path(tmp).rglob("*")
                         if p.is_file())
            saved = cpu_copy(torch, state.state_dict())
            del state, step
            torch.cuda.empty_cache()
            fresh, step = make()
            t0 = time.perf_counter()
            got_step, fresh, cursor = mgr.restore(fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            d_restore = state_diff(torch, cpu_copy(torch, fresh.state_dict()), saved)
            if d_restore != 0.0 or got_step != cut or cursor["step"] != cut:
                raise AssertionError(f"resume {name}: the restored state differs "
                                     f"from the saved one by {d_restore}")
            fresh, l2 = run(fresh, step, dev[cut:])
            torch.cuda.synchronize()
        counts = check_counts("cut-save-restore run", steps)
        say(f"resume {name}: {steps} steps cut at {cut}: checkpoint {nbytes} "
            f"bytes, save {save_s:.3f} s, restore {restore_s:.3f} s, the "
            f"restored state bitwise the saved one; launches {counts} over the "
            f"{steps} steps; on {card}")
        say(spread_check(torch, f"resume {name}", refs,
                         (torch.stack(l1 + l2).cpu(), fresh.state_dict()),
                         "resumed run vs uninterrupted, losses and final state"))
        out[name] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                     "launches": counts}
        del fresh, refs
        torch.cuda.empty_cache()
    return out


def phase_quickstart_cli(torch) -> dict:
    """Phase 19: ``launch synth -> preprocess-ctr -> train`` with a copy of
    ``config.toml`` (only ``data_dir``, ``n_epochs = 1``, ``checkpoint_dir``
    and ``checkpoint_every_n_steps`` changed; the dense regime it sets).
    The train process is killed with SIGKILL once a mid-epoch cursor
    exists, then run again: it must resume mid-epoch and log an eval AUC
    in [0, 1].  The data come from the port's ``data/synthetic.py`` with
    ``QS_USERS`` users (``launch synth``'s 120 users give one batch)."""
    import os
    import signal

    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    text = (ROOT / "config.toml").read_text()
    if 'data_dir = "data/goodreads"' not in text or "n_epochs = 2" not in text:
        raise AssertionError("config.toml no longer has the lines this phase edits")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = tmp / "ckpt"
        cfg = tmp / "config.toml"
        cfg.write_text(
            text.replace('data_dir = "data/goodreads"', f'data_dir = "{tmp / "data"}"')
            .replace("n_epochs = 2", "n_epochs = 1")
            + f'checkpoint_dir = "{ck}"\ncheckpoint_every_n_steps = {QS_CKPT_EVERY}\n')
        t0 = time.perf_counter()
        write_synthetic_goodreads(tmp / "data", n_users=QS_USERS)
        if launch.main(["preprocess-ctr", "--config", str(cfg)]) != 0:
            raise AssertionError("launch preprocess-ctr failed")
        etl_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "tdfo_tpu_torch.launch", "train", "--config",
               str(cfg)]
        log1 = tmp / "train1.log"
        with open(log1, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        mid = None
        deadline = time.monotonic() + 600
        try:
            while mid is None and proc.poll() is None and time.monotonic() < deadline:
                for p in sorted(ck.glob("cursor_*.json")) if ck.exists() else []:
                    # a cursor counts once its step is committed
                    if not (ck / p.stem.split("_", 1)[1] / "state.pt").is_file():
                        continue
                    try:
                        c = json.loads(p.read_text())
                    except (OSError, ValueError):
                        continue
                    if not c.get("epoch_complete"):
                        mid = c
                        break
                time.sleep(0.005)
            if proc.poll() is not None:
                raise AssertionError(
                    f"the train run ended (rc {proc.returncode}) before a "
                    f"mid-epoch checkpoint could be killed; log:\n{log1.read_text()[-3000:]}")
            if mid is None:
                raise AssertionError("no mid-epoch cursor within 600 s")
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        from tdfo_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(ck)
        latest = mgr.read_cursor(mgr.latest_step())
        if latest is None or latest.get("epoch_complete"):
            raise AssertionError(f"the killed run's newest checkpoint is not "
                                 f"mid-epoch: {latest}")
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"the resumed train run failed:\n{res.stdout[-3000:]}"
                                 f"\n{res.stderr[-3000:]}")
        recs = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    resumed = [r for r in recs if "resumed_mid_epoch" in r]
    aucs = [r["auc"] for r in recs if "auc" in r]
    steps = [r["steps"] for r in recs if "train_loss_epoch" in r]
    if not resumed or not aucs or not 0.0 <= aucs[-1] <= 1.0:
        raise AssertionError(f"metrics.jsonl lacks resumed_mid_epoch or an eval "
                             f"AUC: {recs}")
    say(f"quickstart_cli: config.toml (dense TwoTower) on the card: synthetic "
        f"{QS_USERS} users + preprocess-ctr {etl_s:.1f} s; SIGKILL after the "
        f"mid-epoch save at step {mid['step']}; the newest checkpoint at step "
        f"{latest['step']}; the restart resumed mid-epoch at step "
        f"{resumed[0]['step']} and finished the epoch ({steps[-1]} steps), "
        f"eval auc {aucs[-1]:.4f}")
    return {"resumed_at": resumed[0]["step"], "auc": aucs[-1]}


def jagged_rows(rng, b: int = B4R_BATCH):
    """A random ragged Bert4Rec batch: per row a length in [1, T], items in
    [1, n_items], 20% masked and labelled; returned packed (values,
    lengths) and padded at the tail ([B, T])."""
    from tdfo_tpu_torch.data.jagged import pack_rows

    n, t = B4R["n_items"], B4R["max_len"]
    items, labels = [], []
    for _ in range(b):
        k = int(rng.integers(1, t + 1))
        it = rng.integers(1, n + 1, k).astype(np.int32)
        m = rng.random(k) < B4R_MASK_PROB
        m[0] = True
        labels.append(np.where(m, it, 0).astype(np.int32))
        items.append(np.where(m, n + 1, it).astype(np.int32))
    iv, il = pack_rows(items, b * t)
    lv, _ = pack_rows(labels, b * t)
    pad = {"item": np.zeros((b, t), np.int32), "label": np.zeros((b, t), np.int32)}
    for r, (it, lb) in enumerate(zip(items, labels)):
        pad["item"][r, :len(it)] = it
        pad["label"][r, :len(lb)] = lb
    return {"item_values": iv, "item_lengths": il, "label_values": lv}, pad


def phase_b4r_jagged(torch, card: str, check_steps: int = 3) -> dict:
    """Phase 20: the Bert4Rec CLI at configs/bert4rec.toml's width with
    ``jagged = true`` and ``attn = "flash"`` (``synth -> preprocess-seq ->
    train``, the flash launches counted); then the jagged step and the
    padded step from b4r_main's initial state on the same 3 batches (and
    dropout draws): losses within rtol 1e-4."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.jagged import jagged_to_dense_per_host
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.bert4rec import PAD_ID
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward, dropout_generator
    from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step

    text = (ROOT / "configs" / "bert4rec.toml").read_text()
    for line in ('data_dir = "data/goodreads"', "n_epochs = 10", 'attn = "full"'):
        if line not in text:
            raise AssertionError(f"configs/bert4rec.toml lost {line!r}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = tmp / "bert4rec.toml"
        cfg.write_text(
            text.replace('data_dir = "data/goodreads"', f'data_dir = "{tmp / "data"}"')
            .replace("n_epochs = 10", "n_epochs = 1")
            .replace('attn = "full"', 'attn = "flash"')
            + "jagged = true\nlog_every_n_steps = 4\n")
        for cmd in ("synth", "preprocess-seq"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_counts()
        trainer = launch.run(["train", "--config", str(cfg), "--log-dir",
                              str(tmp / "logs"), "--device", "cuda"])
        counts = flash_counts()
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "Recall@10" in r]
    n_layers = trainer.model_cfg.n_layers
    if (not steps or not evals or not all(0.0 <= r["Recall@10"] <= 1.0 for r in evals)
            or counts["flash_bwd_dq"] != n_layers * steps
            or counts["flash_bwd_dkv"] != n_layers * steps
            or counts["flash_fwd"] < n_layers * steps):
        raise AssertionError(f"jagged CLI: {steps} steps, launches {counts}, "
                             f"evals {evals}")
    say(f"b4r_jagged: configs/bert4rec.toml (d {trainer.model_cfg.embed_dim}, "
        f"{n_layers} layers, T {trainer.model_cfg.max_len}, B "
        f"{trainer.config.per_device_train_batch_size}) with jagged = true, attn "
        f"= flash: {steps} steps, Recall@10 {evals[-1]['Recall@10']:.4f}, "
        f"launches {counts}")
    del trainer

    coll, tables0, backbone0 = b4r_initial()
    t_len = B4R["max_len"]

    def to_dense(batch):
        lengths = batch["item_lengths"]
        return {k: jagged_to_dense_per_host(batch[f"{k}_values"], lengths, t_len,
                                            PAD_ID) for k in ("item", "label")}

    rng = np.random.default_rng(41)
    pairs = [jagged_rows(rng) for _ in range(check_steps)]
    runs = {}
    for mode in ("jagged", "padded"):
        state, _ = b4r_state(torch, coll, tables0, backbone0, "cuda")
        step = make_sparse_train_step(
            coll, bert4rec_sparse_forward(state.backbone),
            batch_transform=to_dense if mode == "jagged" else None)
        zero_counts()
        ls = []
        for jag, pad in pairs:
            b = to_device(torch, jag if mode == "jagged" else pad, "cuda")
            gen = dropout_generator(B4R_SEED + 1, state.step, "cuda")
            state, loss = step(state, b, gen)
            ls.append(float(loss))
        runs[mode] = (ls, flash_counts())
        del state
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(runs["jagged"][0], runs["padded"][0], rtol=rtol,
                               atol=atol)
    say(f"b4r_jagged: jagged vs padded step from one state on {check_steps} "
        f"batches at b4r_main's width (dropout {B4R['dropout']}): losses "
        f"{runs['jagged'][0]} vs {runs['padded'][0]} (rtol {rtol}); launches "
        f"{runs['jagged'][1]}, on {card}")
    return {"launches": counts}


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                   help="comma-separated subset of " + ",".join(DEFAULT_PHASES)
                        + ",profile,profile_b4r,profile_dlrm,profile_bf16,"
                        "profile_dlrm_bf16,profile_dense (default: all but "
                        "the profiles)")
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import tdfo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    say(f"device: {kind}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    from tdfo_tpu_torch.ops.kernels.build import build_all

    if "build" in phases:
        t0 = time.perf_counter()
        res = build_all()
        for r in res.values():
            say(f"build: {r.name} -> {r.path.relative_to(ROOT)} in "
                f"{r.seconds:.2f} s\n{r.log.strip()}")
        say(f"build: all kernels in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    recs = {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": None, "max_abs_err": None,
                   "ms": None, "device_ms": None, "device_records": None,
                   "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
                   "library_device_ms": None}
            for name, source, replaces in KERNEL_TABLE}
    fat, routed = recs["fat_line_update"], recs["fat_line_update_routed"]
    floors = {}  # the empty-kernel launch floor of each timing phase
    if "oracle" in phases:
        fat.update(phase_oracle(torch, rng))
    if "timing" in phases:
        t = phase_timing(torch, rng)
        floors["timing"] = t["floor"]
        fat.update(ms=t["ms"], device_ms=t["device_ms"],
                   device_records=t["device_records"], plain_ms=t["plain_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   max_abs_err=max(fat["max_abs_err"] or 0.0, t["max_abs_err"]),
                   shapes=t["shapes"])
    if "main" in phases:
        fat["launches"] = phase_main_path(torch, smi)["launches"]
    if "cli" in phases:
        phase_cli(torch)
    if "flash_oracle" in phases:
        worst = phase_flash_oracle(torch)
        for k in FLASH_KERNELS:  # f32 is the main path's type
            recs[k].update(max_abs_err=worst["f32"][k],
                           max_abs_err_bf16=worst["bf16"][k])
    if "flash_timing" in phases:
        main = phase_flash_timing(torch)
        floors["flash_timing"] = main.pop("floor")
        for k, t in main.items():
            err = t.pop("max_abs_err")
            recs[k].update(t, max_abs_err=max(recs[k]["max_abs_err"] or 0.0, err))
    if "b4r_main" in phases:
        counts = phase_b4r_main(torch, smi)["launches"]
        for k in FLASH_KERNELS:
            recs[k]["launches"] = counts[k]
    if "b4r_cli" in phases:
        phase_b4r_cli(torch)
    if "routed_oracle" in phases:
        routed.update(phase_routed_oracle(torch, rng))
    if "routed_timing" in phases:
        t = phase_routed_timing(torch, rng)
        floors["routed_timing"] = t.pop("floor")
        err = t.pop("max_abs_err")
        routed.update(t, max_abs_err=max(routed["max_abs_err"] or 0.0, err))
    if "dlrm_main" in phases:
        routed["launches"] = phase_dlrm_main(torch, smi)["launches"][
            "fat_line_update_routed"]
    if "dlrm_cli" in phases:
        phase_dlrm_cli(torch)
    fat16 = recs["fat_line_update[bf16]"]
    routed16 = recs["fat_line_update_routed[bf16]"]
    if "bf16_oracle" in phases:
        r = phase_bf16_oracle(torch, rng)
        fat16["max_abs_err"], routed16["max_abs_err"] = r["fat"][0], r["routed"][0]
        fat16["one_ulp_elements"] = r["fat"][1]
        routed16["one_ulp_elements"] = r["routed"][1]
    if "bf16_timing" in phases:
        t = phase_bf16_timing(torch, rng)
        floors["bf16_timing"] = t.pop("floor")
        for rec, key in ((fat16, "fat_line_update[bf16]"),
                         (routed16, "fat_line_update_routed[bf16]")):
            err = t[key].pop("max_abs_err")
            rec.update(t[key], max_abs_err=max(rec["max_abs_err"] or 0.0, err))
    if "main_bf16" in phases:
        fat16["launches"] = phase_main_bf16(torch, smi)["launches"]
    if "dlrm_bf16_main" in phases:
        routed16["launches"] = phase_dlrm_bf16_main(torch, smi)["launches"][
            "fat_line_update_routed"]
    if "dense_main" in phases:
        phase_dense_main(torch, smi)
    if "resume" in phases:
        phase_resume(torch, smi)
    if "quickstart_cli" in phases:
        phase_quickstart_cli(torch)
    if "b4r_jagged" in phases:
        phase_b4r_jagged(torch, smi)
    if "profile" in phases:
        phase_profile(torch)
    if "profile_b4r" in phases:
        phase_profile_b4r(torch)
    if "profile_dlrm" in phases:
        phase_profile_dlrm(torch)
    if "profile_bf16" in phases:
        phase_profile_bf16(torch)
    if "profile_dlrm_bf16" in phases:
        phase_profile_dlrm_bf16(torch)
    if "profile_dense" in phases:
        phase_profile_dense(torch)
    if floors:
        say(f"launch floor (empty kernel, ms): {json.dumps(floors)}")
    say(json.dumps({"kernels": list(recs.values())}))
    say(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
