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
   table bitwise unchanged.  Then CUDA-event times of the kernel and the
   plain version at the main path's shape, with L2 flushed before each
   launch, beside the bound (the larger of bytes / HBM rate and f32
   operations / peak f32 rate), after holding the kernel against the plain
   version on those same operands.
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

``--phases profile`` (not in the default run) adds a ``torch.profiler``
breakdown of steady main-path steps.

Output: a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
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
ADAM_FLOP_PER_ELEMENT = 16  # mu 3, nu 4, 2 bias divides, sqrt, eps, divide, wd 2, lr, subtract
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")


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
    ks, ps = [], []
    for _ in range(2):  # in turns: kernel, plain, kernel, plain
        ks.append(timed_ms(torch, run_k, 50, flush))
        ps.append(timed_ms(torch, run_p, 20, flush))
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
        f"kernel {ks} ms, plain {ps} ms; bound {bound:.6f} ms by {bound_by} "
        f"({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s = {bytes_ms:.6f} ms; "
        f"{flops} f32 flop at {F32_FLOP_PER_S / 1e12} TFLOP/s = {ops_ms:.6f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": err}


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


def phase_profile(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile``): ``torch.profiler`` over ``steps``
    steady main-path steps; prints device time by kernel and the device's
    busy share of the window (host clock)."""
    from torch.profiler import ProfilerActivity, profile

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
    for b in batches[:warm]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[warm:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    n_kernels = sum(e.count for e in events)
    say(f"profile: {steps} steps, wall {wall_ms:.4f} ms ({wall_ms / steps:.4f} "
        f"ms/step), device busy {dev_us / 1e3:.4f} ms "
        f"({100 * dev_us / 1e3 / wall_ms:.2f}% of the window), "
        f"{n_kernels / steps:.1f} device ops per step")
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    for e in top[:15]:
        say(f"  {getattr(e, 'self_device_time_total', 0.0) / steps:10.2f} us/step "
            f"x{e.count // steps:<4d} {e.key[:110]}")


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


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="build,oracle,timing,main,cli",
                   help="comma-separated subset of build,oracle,timing,main,"
                        "cli,profile (default: all but profile)")
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
    rec = {"name": "fat_line_update", "route": "cuda",
           "source": "tdfo_tpu_torch/ops/csrc/fat_line_update.cu",
           "replaces": "tdfo_tpu/ops/pallas_kernels.py:885",
           "launches": None, "max_abs_err": None, "ms": None,
           "plain_ms": None, "bound_ms": None, "bound_by": "bytes",
           "library_ms": None}
    if "oracle" in phases:
        rec.update(phase_oracle(torch, rng))
    if "timing" in phases:
        t = phase_timing(torch, rng)
        rec.update(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"],
                   max_abs_err=max(rec["max_abs_err"] or 0.0, t["max_abs_err"]))
    if "main" in phases:
        rec["launches"] = phase_main_path(torch, smi)["launches"]
    if "cli" in phases:
        phase_cli(torch)
    if "profile" in phases:
        phase_profile(torch)
    say(json.dumps({"kernels": [rec]}))
    say(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
