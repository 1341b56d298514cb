"""Serving over a mesh on two gloo ranks (``tests/torch_dist_worker.py``,
spawned once for the file; ``launch serve`` through
``torch.distributed.run`` beside them), against the port's one-device
serving and the JAX package's sharded programs:

* a 1,001-item catalogue (it does not divide the 2 shards) in f32, bf16
  and int8, exact and two-stage (``coarse_k`` 300) at top-k 10 and 100:
  each rank returns the one-device ids at every separated rank and
  scores at rtol 1e-5 (``torch_serve_helpers.assert_retrieval_matches``),
  and so does the JAX ``make_retrieval(mesh=...)`` on a data-2 mesh; no
  padding id is ever returned; equal rows on both sides of the shard
  boundary go to the lower id;
* a corpus exported at world 2 loads at world 1 bitwise, and one exported
  at world 1 loads at world 2 as the two padded shards;
* ``serve_from_config`` at data 1 x model 2 (the tables row-sharded,
  from the seeded init) writes the one-device bundle (the same digest)
  from rank 0, and both ranks serve the same requests;
* ``launch serve`` on two ranks at data 2 (int8 two-stage over the
  sharded corpus) gives the one-device serve's stats; only rank 0 prints
  them and writes ``metrics.jsonl``.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import REPO, Ranks
from torch_serve_helpers import assert_retrieval_matches

from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu.serve import export as jexp
from tdfo_tpu.serve import retrieval as jret
from tdfo_tpu_torch import launch
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.serve import corpus as tcorp
from tdfo_tpu_torch.serve import export as texp
from tdfo_tpu_torch.serve import retrieval as tret
from tdfo_tpu_torch.serve.frontend import serve_from_config

N, D, B = 1001, 16, 16
EDGE = 500  # rows 500 | 501 straddle the shard boundary (501 rows a shard)
CONFIGS = [(dt, k, coarse) for dt in ("float32", "bfloat16", "int8")
           for k in (10, 100) for coarse in (0, 300)]
# the stats that do not depend on the host's clock
STABLE = ("requests", "batches", "shed", "swaps", "programs", "step",
          "retrieved")


def _catalogue():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows[EDGE + 1] = rows[EDGE]  # a tie across the boundary
    q = rng.standard_normal((B, D)).astype(np.float32)
    q[0] = 4 * rows[EDGE]  # ranks the tied pair first
    return rows, np.arange(N, dtype=np.int32), q


def _toml(body: dict) -> dict:
    return dict(model="twotower", model_parallel=True, embed_dim=16,
                fused_table_threshold=0, n_epochs=1,
                per_device_train_batch_size=256, per_device_eval_batch_size=256,
                log_every_n_steps=4, **body)


def _write_toml(path: Path, body: dict) -> Path:
    lines, tables = [], []
    for k, v in body.items():
        if isinstance(v, dict):
            tables.append(f"[{k}]\n" + "".join(f"{a} = {json.dumps(b)}\n"
                                               for a, b in v.items()))
        else:
            lines.append(f"{k} = {json.dumps(v)}")
    path.write_text("\n".join(lines) + "\n" + "\n".join(tables))
    return path


@functools.lru_cache(maxsize=None)
def _runs():
    tmp = Path(tempfile.mkdtemp(prefix="sh_serve_"))
    ranks = Ranks(2, tmp / "ranks")
    rows, ids, q = _catalogue()
    one = {dt: tcorp.store_corpus(torch.from_numpy(rows), torch.from_numpy(ids), N, dt)
           for dt in ("float32", "bfloat16", "int8")}
    for dt, c in one.items():
        texp.export_corpus(tmp / "w1" / dt, c)
    # the synthetic catalogue; every serve starts from the seeded init
    base = _toml(dict(data_dir=str(tmp / "data")))
    cfg = _write_toml(tmp / "data.toml", base)
    for cmd in ("synth", "preprocess-ctr"):
        launch.main([cmd, "--config", str(cfg)])
    ranks.send({
        "retrieval": dict(fn="retrieval", mesh=(2, 1), rows=rows, ids=ids,
                          queries=q, configs=CONFIGS, export=str(tmp / "w2"),
                          load=str(tmp / "w1")),
        "serve_m2": dict(fn="serve", log_dir=str(tmp / "serve_m2"),
                         body=dict(base, mesh={"data": 1, "model": 2})),
    })
    # launch serve on two ranks at data 2, int8 two-stage, beside the ranks
    cli = _write_toml(tmp / "serve.toml", dict(
        base, mesh={"data": 2, "model": 1},
        serving={"coarse_k": 150, "coarse_dtype": "int8"}))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}{os.pathsep}" + os.environ.get("PYTHONPATH", ""))
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--standalone", "-m", "tdfo_tpu_torch.launch", "serve",
         "--config", str(cli), "--device", "cpu", "--log-dir", str(tmp / "cli")],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the one-device and JAX sides while the ranks run
    jmesh = make_mesh(JMeshSpec(data=2, model=1, seq=1), devices=jax.devices()[:2])
    want, jax_got = {}, {}
    for dt, k, coarse in CONFIGS:
        want[dt, k, coarse] = tret.make_retrieval(one[dt], top_k=k, coarse_k=coarse)(
            torch.from_numpy(q))
        jc = jexp.load_corpus(tmp / "w1" / dt, mesh=jmesh)
        jax_got[dt, k, coarse] = jret.make_retrieval(
            jc, mesh=jmesh, top_k=k, coarse_k=coarse)(jnp.asarray(q))
    ref = {dt: tret.retrieval_reference(torch.from_numpy(q), c, top_k=101)[0]
           for dt, c in one.items()}
    serve_one = serve_from_config(read_configs(None, **base),
                                  log_dir=tmp / "serve_w1", device="cpu")
    log, _ = torchrun.communicate(timeout=240)
    assert torchrun.returncode == 0, log[-4000:]
    return {"results": ranks.wait(), "one": one, "want": want, "jax": jax_got,
            "ref": ref, "serve_one": serve_one, "cli_log": log, "tmp": tmp}


def _got(cfg):
    return [r["retrieval"]["got"][cfg] for r in _runs()["results"]]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"{d}-k{k}-c{c}" for d, k, c in CONFIGS])
def test_sharded_retrieval_matches_one_device_and_jax(cfg):
    s = _runs()
    dt, k, _ = cfg
    ref = s["ref"][dt][:, :k + 1]
    for got in _got(cfg):
        assert (got[1] >= 0).all() and got[1].max() < N  # never a padding id
        assert_retrieval_matches(got, s["want"][cfg], ref)
        assert_retrieval_matches(got, s["jax"][cfg], ref)
        # the tie across the shard boundary: the lower id first
        assert list(got[1][0, :2]) == [EDGE, EDGE + 1]
        assert got[0][0, 0] == got[0][0, 1]
    a, b = _got(cfg)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
def test_corpus_stored_at_one_world_loads_at_another(dt):
    s = _runs()
    one = s["one"][dt]
    # exported at world 2 (gathered to rank 0), loaded at world 1: bitwise
    back = texp.load_corpus(s["tmp"] / "w2" / dt, device="cpu")
    assert torch.equal(back.vectors, one.vectors) and torch.equal(back.ids, one.ids)
    assert (back.qscale is None) == (one.qscale is None)
    if one.qscale is not None:
        assert torch.equal(back.qscale, one.qscale)
    # exported at world 1, loaded at world 2: the two padded shards
    parts = [r["retrieval"]["loaded"][dt] for r in s["results"]]
    assert [p["shard"] for p in parts] == [(0, 2), (1, 2)]
    ids = np.concatenate([p["ids"] for p in parts])
    assert ids.shape == (2 * 501,) and (ids[N:] == -1).all()
    np.testing.assert_array_equal(ids[:N], one.ids.numpy())
    vec = np.concatenate([p["vectors"] for p in parts])
    stored = one.vectors.view(torch.int16) if dt == "bfloat16" else one.vectors
    np.testing.assert_array_equal(vec[:N], stored.numpy())
    pad = tcorp.store_corpus(torch.zeros((1, D)), torch.full((1,), -1), 1, dt)
    pv = pad.vectors.view(torch.int16) if dt == "bfloat16" else pad.vectors
    np.testing.assert_array_equal(vec[N:], np.repeat(pv.numpy(), 2 * 501 - N, 0))
    if one.qscale is not None:
        qs = np.concatenate([p["qscale"] for p in parts])
        np.testing.assert_array_equal(qs[:N], one.qscale.numpy())
        np.testing.assert_array_equal(qs[N:], np.repeat(pad.qscale.numpy(), 1, 0))


def test_world_two_bundle_is_the_one_device_bundle():
    """Rank 0 gathers the row-sharded tables (data 1 x model 2) and writes
    the one-device bundle; every rank serves the same requests."""
    s = _runs()
    res = [r["serve_m2"] for r in s["results"]]
    want = json.loads((Path(s["serve_one"]["bundle"]) / "bundle.json").read_text())
    for r in res:
        assert r["digest"] == want["digest"]
        assert {k: r["stats"][k] for k in STABLE} == {k: s["serve_one"][k]
                                                      for k in STABLE}


def test_launch_serve_on_two_ranks():
    """Rank 0 alone prints and writes; its stats are the one-device
    serve's, retrieval over the corpus sharded in two included."""
    s = _runs()
    lines = [x for x in s["cli_log"].splitlines() if x.startswith("{'requests'")]
    assert len(lines) == 1, s["cli_log"][-3000:]
    out = eval(lines[0], {"inf": float("inf")})  # noqa: S307 (the printed dict)
    assert {k: out[k] for k in STABLE} == {k: s["serve_one"][k] for k in STABLE}
    assert out["retrieved"] == 100
    recs = [json.loads(x) for x in (s["tmp"] / "cli" / "metrics.jsonl")
            .read_text().splitlines()]
    assert sum(r.get("event") == "serve_summary" for r in recs) == 1
