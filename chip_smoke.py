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
   those same operands.
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
   ``n_epochs = 1``; ``metrics.jsonl`` must hold eval AUC.
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

``--phases profile`` / ``profile_b4r`` / ``profile_dlrm`` (not in the
default run) add a ``torch.profiler`` breakdown of steady TwoTower /
Bert4Rec / DLRM-Criteo main-path steps.

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
_CSRC, _PK = "tdfo_tpu_torch/ops/csrc/", "tdfo_tpu/ops/pallas_kernels.py:"
KERNEL_TABLE = (  # name, source, the TPU kernel it replaces
    ("fat_line_update", _CSRC + "fat_line_update.cu", _PK + "885"),
    ("fat_line_update_routed", _CSRC + "fat_line_update_routed.cu", _PK + "1122"),
    ("flash_fwd", _CSRC + "flash_attn_fwd.cu", _PK + "73"),
    ("flash_bwd_dq", _CSRC + "flash_attn_bwd.cu", _PK + "222"),
    ("flash_bwd_dkv", _CSRC + "flash_attn_bwd.cu", _PK + "261"),
)
DEFAULT_PHASES = ("build", "oracle", "timing", "main", "cli", "flash_oracle",
                  "flash_timing", "b4r_main", "b4r_cli", "routed_oracle",
                  "routed_timing", "dlrm_main", "dlrm_cli")


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
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": sum(ds[-2:]) / 2,
            "device_records": rec, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "floor": floor}


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
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = tmp / "config.toml"
        cfg.write_text(
            f'data_dir = "{tmp / "data"}"\n'
            'model = "twotower"\nmodel_parallel = true\nembed_dim = 16\n'
            'fused_table_threshold = 0\nn_epochs = 1\n'
            'per_device_train_batch_size = 256\nper_device_eval_batch_size = 256\n'
            'log_every_n_steps = 4\n')
        for cmd in ("synth", "preprocess-ctr"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        kl.fat_line_update.launches = 0
        rc = launch.main(["train", "--config", str(cfg), "--log-dir",
                          str(tmp / "logs"), "--device", "cuda"])
        launches = kl.fat_line_update.launches
        if rc != 0:
            raise AssertionError("launch train failed")
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    aucs = [r["auc"] for r in recs if "auc" in r]
    tr = [r for r in recs if "train_auc" in r]
    if not aucs or not (0.0 <= aucs[-1] <= 1.0) or not tr:
        raise AssertionError(f"metrics.jsonl lacks eval/train AUC: {recs}")
    if launches <= 0:
        raise AssertionError("CLI train never launched fat_line_update")
    say(f"cli: synth -> preprocess-ctr -> train on the card: eval auc "
        f"{aucs[-1]:.4f}, train_auc {tr[-1]['train_auc']:.4f}, "
        f"fat_line_update launches {launches}")
    return {"launches": launches, "auc": aucs[-1]}


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


def dlrm_state(torch, coll, tables0, backbone0, device):
    """``(state, step)`` on ``device`` from copies of the initial state."""
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
        sparse_opt=sparse_optimizer("rowwise_adagrad", lr=LR),
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
    accumulator; plain: the row and its rowwise accumulator), on the CPU."""
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
            acc = state.slots[aname][0]
            out[aname] = torch.cat([table[idx], acc[idx][:, None]], dim=1).cpu()
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


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                   help="comma-separated subset of " + ",".join(DEFAULT_PHASES)
                        + ",profile,profile_b4r,profile_dlrm (default: all but "
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
                   max_abs_err=max(fat["max_abs_err"] or 0.0, t["max_abs_err"]))
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
    if "profile" in phases:
        phase_profile(torch)
    if "profile_b4r" in phases:
        phase_profile_b4r(torch)
    if "profile_dlrm" in phases:
        phase_profile_dlrm(torch)
    if floors:
        say(f"launch floor (empty kernel, ms): {json.dumps(floors)}")
    say(json.dumps({"kernels": list(recs.values())}))
    say(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
