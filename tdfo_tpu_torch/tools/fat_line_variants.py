"""Time design variants of the ``fat_line_update`` kernel side by side on one
CUDA card.

    python -m tdfo_tpu_torch.tools.fat_line_variants                  # all
    python -m tdfo_tpu_torch.tools.fat_line_variants --variants kernel,cap24

Each variant is the kernel's source (``ops/csrc/fat_line_update.cu`` and
``fat_line_common.cuh``) with the textual edits listed in ``VARIANTS``
(``kernel`` is the source as it stands), built with ``nvcc`` and the flags
of ``ops/kernels/build.py`` into the git-ignored
``tdfo_tpu_torch/build/variants/<name>/`` (all builds at once), loaded with
``ctypes`` and launched at ``chip_smoke.py``'s TwoTower shape: adam d = 64,
700,000 rows, one B = 8192 batch's deduplicated lines (16,384 slots), in
f32 and bf16 with stochastic rounding.  Each variant's table is first held
bitwise against the plain version (the diagnostics ``nomath``, ``nohash``
and ``memonly`` compute something else and are only timed).  Device time is
``chip_smoke.device_ms``'s (the median over 50 launches of the profiler's
kernel duration, L2 flushed by a 256 MB write before each launch, as the
timing phases flush it), two readings per variant in turns, forward then
reverse order; then, for ``CLEAN_L2`` variants, two readings after a
256 MB read that leaves L2 clean.  Prints ``nvcc -Xptxas -v``'s registers
and spills of the TwoTower instances.  Needs the card, ``nvcc`` and the
repository root (for ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "tdfo_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "tdfo_tpu_torch" / "build" / "variants"
KERNEL, COMMON = "fat_line_update.cu", "fat_line_common.cuh"

# bf16 adam at d = 64 with 8 lanes a thread: 16-byte loads of the bf16
# lanes, two of the grads, G = 8 threads a row
_V8_KERNEL = r'''
__device__ __forceinline__ void unpack8(float (&a)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __uint_as_float(w[i] << 16);
    a[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fat_line_update_kernel_v8(Params<uint16_t> p) {
  constexpr int G = 8, RPB = 32 / G * WPB;
  const int lane = threadIdx.x & 31, t = lane % G, d = p.step.d;
  const int n = (int)p.n_slots, stride = (int)gridDim.x * RPB;
  const float c1 = p.step.corr[0], c2 = p.step.corr[1];
  int w0 = (int)blockIdx.x * RPB + (threadIdx.x >> 5) * (32 / G);
  int slot = w0 + lane / G;
  float tch;
  int line = slot_line(p, slot, n, tch);
  for (; w0 < n; w0 += stride, slot += stride) {
    const bool ok = line >= 0 && line < p.n_lines && tch > 0.0f;
    uint16_t* row = p.fat + (int64_t)(ok ? line : 0) * p.w;
    float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), gb = ga;
    uint4 X = make_uint4(0u, 0u, 0u, 0u), M = X, V = X;
    if (slot < n) {
      ga = *reinterpret_cast<const float4*>(p.g + (int64_t)slot * d + 8 * t);
      gb = *reinterpret_cast<const float4*>(p.g + (int64_t)slot * d + 8 * t + 4);
    }
    if (ok) {
      X = *reinterpret_cast<const uint4*>(row + 8 * t);
      M = *reinterpret_cast<const uint4*>(row + d + 8 * t);
      V = *reinterpret_cast<const uint4*>(row + 2 * d + 8 * t);
    }
    float tch_n;
    const int line_n = slot_line(p, slot + stride, n, tch_n);
    float gg[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w}, x[8], m[8], v[8];
    unpack8(x, X);
    unpack8(m, M);
    unpack8(v, V);
#pragma unroll
    for (int e = 0; e < 8; ++e) adam_step(x[e], m[e], v[e], gg[e], c1, c2, p.step);
    if (ok) {
      const Narrow nw = narrow_at(p, slot, 0);
      const float* vals[3] = {x, m, v};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int off = a * d + 8 * t;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = (uint32_t)nw.bits(off + 2 * i, vals[a][2 * i]) |
                 ((uint32_t)nw.bits(off + 2 * i + 1, vals[a][2 * i + 1]) << 16);
        *reinterpret_cast<uint4*>(row + off) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    line = line_n;
    tch = tch_n;
  }
}

'''

_V8_LAUNCH = r'''  if constexpr (std::is_same<S, uint16_t>::value) {
    if (kind == KIND_ADAM && d == 64 && r == 1) {
      int sms = 0, per_sm = 0, dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fat_line_update_kernel_v8, THREADS, 0);
      const int64_t need = (p.n_slots + 4 * WPB - 1) / (4 * WPB);
      const int64_t most = (int64_t)per_sm * sms;
      fat_line_update_kernel_v8<<<(unsigned)(need < most ? need : most), THREADS, 0, s>>>(p);
      return (int)cudaGetLastError();
    }
  }
  switch (kind) {'''

# two passes in flight per group: the next pass's operands are loaded
# before this pass's math, the line of the pass after that is on its way
_PIPE_LOOP = r'''  int w0 = (int)blockIdx.x * RPB + (threadIdx.x >> 5) * RPW;
  int slot = w0 + lane / G;
  float tch, tch_n;
  int line = slot_line(p, slot, n, tch);
  int line_n = slot_line(p, slot + stride, n, tch_n);
  bool ok = line >= 0 && line < p.n_lines && tch > 0.0f;
  S* row = p.fat + ((int64_t)(ok ? line : 0) * p.r + slot % p.r) * (int64_t)p.w;
  RowLanes cur;
  load_row_lanes<KIND>(cur, row, p.g + (int64_t)slot * d, t, d, slot < n && tl, ok && tl,
                       ok && t == 0);
  for (; w0 < n; w0 += stride, slot += stride) {
    const int sn = slot + stride;
    const bool ok_n = line_n >= 0 && line_n < p.n_lines && tch_n > 0.0f;
    S* row_n = p.fat + ((int64_t)(ok_n ? line_n : 0) * p.r + sn % p.r) * (int64_t)p.w;
    RowLanes nxt;
    load_row_lanes<KIND>(nxt, row_n, p.g + (int64_t)sn * d, t, d, sn < n && tl, ok_n && tl,
                         ok_n && t == 0);
    float tch_nn;
    const int line_nn = slot_line(p, sn + stride, n, tch_nn);
    const int u = p.r == 1 ? slot : slot / p.r;
    const int s = slot - u * p.r;
    if (KIND == KIND_ROWWISE_ADAGRAD) cur.acc = __shfl_sync(0xffffffffu, cur.acc, lane & ~(G - 1));
    fat_row_group_step<KIND, G>(cur, row, t, d, ok, ok && tl, p.step, c1, c2,
                                narrow_at(p, u, s));
    cur = nxt;
    row = row_n;
    ok = ok_n;
    line_n = line_nn;
    tch_n = tch_nn;
  }
}

'''


def _between(start: str, end: str, new: str):
    """An edit replacing the text from ``start`` up to ``end`` (kept)."""
    def edit(src: str) -> str:
        i = src.index(start)
        j = src.index(end, i)
        return src[:i] + new + src[j:]
    return edit


def _sub(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"variant edit: {old[:60]!r} not in the source")
        return src.replace(old, new)
    return edit


# name -> (what it tests, {file: [edits]})
VARIANTS = {
    "kernel": ("the source as it stands", {}),
    "grad_after_line": ("the grad's load waits for the line", {KERNEL: [_sub(
        "t, d, slot < n && tl, ok && tl,", "t, d, ok && tl, ok && tl,")]}),
    "threads128": ("128-thread blocks, at least 10 a SM", {KERNEL: [_sub(
        "constexpr int THREADS = 64;\nconstexpr int MIN_BLOCKS = 20;",
        "constexpr int THREADS = 128;\nconstexpr int MIN_BLOCKS = 10;")]}),
    "threads256": ("256-thread blocks, at least 5 a SM", {KERNEL: [_sub(
        "constexpr int THREADS = 64;\nconstexpr int MIN_BLOCKS = 20;",
        "constexpr int THREADS = 256;\nconstexpr int MIN_BLOCKS = 5;")]}),
    "no_cap": ("no register cap (64-thread blocks)", {KERNEL: [_sub(
        "__launch_bounds__(THREADS, MIN_BLOCKS) fat_line_update_kernel(",
        "__launch_bounds__(THREADS) fat_line_update_kernel(")]}),
    "cap24": ("at least 24 blocks a SM (40 registers)", {KERNEL: [_sub(
        "constexpr int MIN_BLOCKS = 20;", "constexpr int MIN_BLOCKS = 24;")]}),
    "cap32": ("at least 32 blocks a SM (32 registers)", {KERNEL: [_sub(
        "constexpr int MIN_BLOCKS = 20;", "constexpr int MIN_BLOCKS = 32;")]}),
    "grid_per_slot": ("one block per 32 / G * 2 slots, no resident loop", {KERNEL: [_sub(
        "<<<(unsigned)(need < most ? need : most), THREADS, 0, s>>>",
        "<<<(unsigned)need, THREADS, 0, s>>>")]}),
    "ldcs_grad": ("the grad loaded with __ldcs (evict first)", {COMMON: [_sub(
        "  ld4(r.g, g + 4 * t, g_live);",
        "  {\n    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);\n"
        "    if (g_live) v = __ldcs(reinterpret_cast<const float4*>(g + 4 * t));\n"
        "    r.g[0] = v.x; r.g[1] = v.y; r.g[2] = v.z; r.g[3] = v.w;\n  }")]}),
    "two_passes": ("the next pass's operands loaded before this pass's math", {KERNEL: [
        _between("  int w0 = (int)blockIdx.x * RPB + (threadIdx.x >> 5) * RPW;",
                 "// Rows the groups cannot take", _PIPE_LOOP)]}),
    "bf16_8_lanes": ("bf16 adam d = 64: 8 lanes a thread, 16-byte loads", {KERNEL: [
        _between("// Blocks the card keeps resident", "// Blocks the card keeps resident",
                 _V8_KERNEL),
        _sub("  switch (kind) {", _V8_LAUNCH)]}),
    "nomath": ("diagnostic: adam's math replaced by x + g", {COMMON: [_sub(
        "for (int e = 0; e < 4; ++e) adam_step(r.x[e], r.s1[e], r.s2[e], r.g[e], c1, c2, p);",
        "for (int e = 0; e < 4; ++e) r.x[e] += r.g[e];")]}),
    "nohash": ("diagnostic: bf16 lanes truncated, no rounding hash", {COMMON: [_sub(
        "    if (!sr) return __bfloat16_as_ushort(__float2bfloat16_rn(v));",
        "    return (uint16_t)(__float_as_uint(v) >> 16);")]}),
}
VARIANTS["memonly"] = ("diagnostic: nomath and nohash (loads and stores only)", {
    COMMON: VARIANTS["nomath"][1][COMMON] + VARIANTS["nohash"][1][COMMON]})
DIAGNOSTIC = ("nomath", "nohash", "memonly")
CLEAN_L2 = ("kernel", "grid_per_slot", "memonly")


def build(names):
    """Write and build every variant at once; returns ``{name: (lib, log)}``."""
    from tdfo_tpu_torch.ops.kernels.build import NVCC_FLAGS, _nvcc

    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in (KERNEL, COMMON):
            src = (CSRC / f).read_text()
            for edit in VARIANTS[name][1].get(f, []):
                src = edit(src)
            (d / f).write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / KERNEL)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        out[name] = (ctypes.CDLL(str(OUT / name / "lib.so")), log)
    return out


def ptxas_summary(log: str) -> str:
    """Registers and spill stores of the adam G = 16 instances (and the
    8-lane kernel) in ``-Xptxas -v``'s log."""
    res = []
    for m in re.finditer(r"Compiling entry function '(\w+)'((?:(?!Compiling).)*?)"
                         r"(\d+) bytes spill stores(?:(?!Compiling).)*?Used (\d+) registers",
                         log, re.S):
        fn, _, spill, regs = m.groups()
        if "ILi3ELi16E" in fn or "_v8" in fn:
            kind = "bf16" if re.search(r"[EI]tE", fn) else "f32"
            res.append(f"{kind}{' 8-lane' if '_v8' in fn else ''} {regs} registers, "
                       f"{spill} B spilled")
    return "; ".join(res)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated subset of " + ",".join(VARIANTS))
    names = p.parse_args(argv).variants.split(",")
    if "kernel" in names:
        names.remove("kernel")
    names.insert(0, "kernel")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fat_line_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import LANE, line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi_line()}")
    libs = build(names)
    for name in names:
        print(f"{name} ({VARIANTS[name][0]}): {ptxas_summary(libs[name][1])}")
    vp, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    clean = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = cs.SIZE_MAP["user"] + cs.SIZE_MAP["item"]
    ids = np.concatenate([rng.integers(0, cs.SIZE_MAP["user"], cs.BATCH),
                          cs.SIZE_MAP["user"] + rng.integers(0, cs.SIZE_MAP["item"], cs.BATCH)])
    ul, _, valid = sp.dedupe_ids(torch.from_numpy(ids).cuda(), vocab=rows)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        lay = line_layout(cs.DIM, "adam", dtype)
        fat = cs.random_fat(torch, lay, rows, gen).to(getattr(torch, dtype))
        g = torch.randn((ul.shape[0], cs.DIM), generator=gen, device="cuda") * 1e-3
        seed = cs.SR_SEED if bf16 else None
        sr = ((seed, 1, kl.grid_lines_per_step(ul.shape[0]), lay.tiles * LANE)
              if bf16 else ())
        plain = fat.clone()
        kl.fat_line_update_plain(plain, ul, g, None, corr, layout=lay, lr=cs.LR,
                                 weight_decay=cs.WD, sr_seed=seed)
        bits = torch.int16 if bf16 else torch.int32
        runs = {}
        for name in names:
            fn = libs[name][0].fat_line_update_bf16 if bf16 else libs[name][0].fat_line_update_f32
            fn.argtypes = ([vp] * 5 + [i64, i64, i32, i32, i32, i32] + [f32] * 7
                           + ([ctypes.c_uint32, i32, i32, i32] if bf16 else []) + [vp])
            fn.restype = ctypes.c_int

            def run(f=fat, fn=fn):
                err = fn(f.data_ptr(), ul.data_ptr(), g.data_ptr(), None, corr.data_ptr(),
                         f.shape[0], ul.shape[0], lay.r, lay.w, lay.d, kl.KIND_CODES["adam"],
                         cs.LR, 0.9, 0.999, 1 - 0.9, 1 - 0.999, 1e-8, cs.WD, *sr, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            out = fat.clone()
            run(out)
            torch.cuda.synchronize()
            same = torch.equal(out.view(bits), plain.view(bits))
            if name not in DIAGNOSTIC and not same:
                raise AssertionError(f"{dtype} {name}: not bitwise the plain version")
            runs[name] = run
        for run in runs.values():
            for _ in range(3):
                run()
        reads = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                reads[name].append(cs.device_ms(torch, runs[name], 50, flush,
                                                "fat_line_update_kernel")[0])
        for name in names:
            line = f"{dtype} {name}: dev ms {reads[name]}"
            if name in CLEAN_L2:
                cl = [cs.device_ms(torch, lambda r=runs[name]: (clean.sum(), r()), 50,
                                   flush, "fat_line_update_kernel")[0] for _ in range(2)]
                line += f", clean L2 {cl}"
            print(line + f" ({int(valid.sum())} touched lines of {ul.shape[0]})", flush=True)
        del fat, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
