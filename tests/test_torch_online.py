"""The port's plain online loop (``tdfo_tpu_torch/train/online.py``) against
``tdfo_tpu/train/online.py`` on the CPU, and its kill drill.

Both loops replay one request log (written with rotation on, labelled
rows) from one initial state (``torch_online_helpers.carry_into_port``)
through two cycles of two steps on a DMP TwoTower, each serving through
one ``MicroBatcher``.  Held to the reference:

* the bootstrap bundle (v0, the initial state) is bitwise the reference's:
  manifest, digest and every stored array's bytes;
* each cycle consumes the same ``(seq, row_start, row_end)`` spans and
  publishes the same version; cursors and ``replay/*`` counters are equal;
* the tables and the backbone after two cycles agree at rtol 1e-4, atol
  1e-6 (``interop.TOL["trajectory"]``: the optimizer's f32 math differs
  from jitted JAX in the last bit, so composed steps are held at the
  ladder's trajectory rung);
* the loop's refusals are the reference's, message for message.

The kill drill is the port's alone (as the reference's own is): a run
killed by ``kill_between_stages`` at the cycle-2 export boundary (after
the checkpoint claimed version 2, before the store caught up: the
``_catch_up`` path) and restarted with the same command ends bitwise on
the uninterrupted run's bundle digest, replay cursor and probe logits, and
the killed and resumed lineages together consume every record once.
"""

import json

import numpy as np
import pytest
import torch

from torch_online_helpers import (
    BATCH,
    bundle_bytes,
    carry_into_port,
    ctr_env,
    jax_loop,
    loop_kwargs,
    online_cycles,
    spawn_port_worker,
)

from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.train.online import OnlineLoop
from tdfo_tpu_torch.utils import faults as tfaults

N_CYCLES = 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return ctr_env(tmp_path_factory.mktemp("online"), n_batches=N_CYCLES * 2)


def _probe(env):
    rng = np.random.default_rng(606)
    out = []
    for i, n in enumerate((3, 5, 2, 8)):
        cols = {c: rng.integers(0, env["vocab"][c], size=n).tolist()
                for c in env["cat_cols"]}
        for c in env["cont_cols"]:
            cols[c] = rng.random(n, dtype=np.float32).tolist()
        out.append([f"probe{i}", cols])
    return out


@pytest.fixture(scope="module")
def kill_procs(env, tmp_path_factory):
    """The port's kill drill, started first so its processes run while the
    parity fixture computes the reference: a lineage killed at the cycle-2
    export boundary (stage call 10) beside an uninterrupted one."""
    tmp = tmp_path_factory.mktemp("online_kill")
    specs = {}
    for name, faults in (("killed", {"kill_between_stages": 10}), ("ref", {})):
        specs[name] = dict(kw=loop_kwargs(env, tmp / f"ck_{name}", faults=faults),
                           log_dir=str(tmp / f"log_{name}"),
                           out_json=str(tmp / f"{name}.json"), probe=_probe(env))
    procs = {n: spawn_port_worker(s, tmp / f"{n}_spec.json") for n, s in specs.items()}
    yield tmp, specs, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def parity(env, kill_procs, tmp_path_factory):
    """Both packages' loops, drained from the same initial state."""
    tmp = tmp_path_factory.mktemp("online_parity")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            jloop = jax_loop(mp, loop_kwargs(env, tmp / "jck"), tmp / "jlog")
            tkw = loop_kwargs(env, tmp / "tck")
            carry_into_port(jloop, tkw)
            tloop = OnlineLoop(read_configs(None, **tkw), log_dir=str(tmp / "tlog"),
                               device="cpu")
            v0 = (bundle_bytes(jloop.store.current_dir()),
                  bundle_bytes(tloop.store.current_dir()))
            stats = (jloop.run(), tloop.run())
            out = dict(
                v0=v0, stats=stats, tmp=tmp,
                cursors=(jloop.consumer.cursor(), tloop.consumer.cursor()),
                cycles=(online_cycles(tmp / "jlog" / "metrics.jsonl"),
                        online_cycles(tmp / "tlog" / "metrics.jsonl")),
                jstate=jloop.trainer.state, tstate=tloop.trainer.state)
            tloop.close()
            jloop.close()
    finally:
        torch.set_num_threads(n)
        jfaults.configure(None)
        tfaults.configure(None)
    return out


def test_bootstrap_bundle_is_bitwise_the_reference(parity):
    jv0, tv0 = parity["v0"]
    assert tv0["manifest"] == jv0["manifest"]
    assert tv0["arrays"] == jv0["arrays"]


def test_cycles_consume_the_same_spans_and_versions(parity):
    jc, tc = parity["cycles"]
    assert len(tc) == len(jc) == N_CYCLES
    for j, t in zip(jc, tc):
        for key in ("cycle", "global_step", "steps", "version", "consumed",
                    "replay/records", "replay/bad", "replay/dup",
                    "replay/skipped", "replay/lag"):
            assert t[key] == j[key], key
        assert np.isfinite(t["loss"])
    assert parity["cursors"][1] == parity["cursors"][0]
    js, ts = parity["stats"]
    assert {k: v for k, v in ts.items() if k != "bundle"} == \
        {k: v for k, v in js.items() if k != "bundle"}


def test_tables_after_two_cycles_match_the_reference(parity):
    import jax

    from tdfo_tpu_torch.interop import backbone_params_from_flax

    rtol, atol = TOL["trajectory"]
    js, ts = parity["jstate"], parity["tstate"]
    assert sorted(ts.tables) == sorted(js.tables)
    for name, t in ts.tables.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(js.tables[name]),
                                   rtol=rtol, atol=atol, err_msg=name)
    want = backbone_params_from_flax(jax.tree.map(np.asarray, js.dense_params))
    for name, t in ts.backbone.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _refusal(make):
    try:
        make()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["no_request_log", "steps_per_execution",
                                  "dense_regime", "no_checkpoint_dir",
                                  "several_processes"])
def test_loop_refusals_are_the_reference(env, tmp_path, monkeypatch, case):
    import jax
    import torch.distributed as dist

    from tdfo_tpu.core.config import read_configs as j_read_configs
    from tdfo_tpu.train.online import OnlineLoop as JLoop

    kw = loop_kwargs(env, tmp_path / "ck")
    if case == "no_request_log":
        kw["online"]["request_log"] = ""
    elif case == "steps_per_execution":
        kw["steps_per_execution"] = 2
    elif case == "dense_regime":
        kw["model_parallel"] = False
    elif case == "no_checkpoint_dir":
        kw["checkpoint_dir"] = ""
    else:
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    got = _refusal(lambda: OnlineLoop(read_configs(None, **kw), device="cpu"))
    assert got is not None
    if case == "dense_regime":
        # the reference builds its whole dense trainer first; the refusal
        # is the message both packages raise
        assert got[1].startswith("online requires the DMP/sparse regime")
        return
    assert got == _refusal(lambda: JLoop(j_read_configs(None, **kw)))


@pytest.fixture(scope="module")
def kill_runs(kill_procs):
    """The drill's outcome: the killed lineage restarted with the same
    command."""
    tmp, specs, procs = kill_procs
    outs = {n: p.communicate(timeout=300)[0] for n, p in procs.items()}
    assert procs["killed"].returncode == tfaults.KILL_EXIT_CODE, outs["killed"][-3000:]
    assert procs["ref"].returncode == 0, outs["ref"][-3000:]
    assert not (tmp / "killed.json").exists()
    assert (tmp / "ck_killed" / "faults_stage_kill.marker").exists()
    p = spawn_port_worker(specs["killed"], tmp / "killed_spec.json")
    out = p.communicate(timeout=300)[0]
    assert p.returncode == 0, out[-3000:]
    return dict(resumed=json.loads((tmp / "killed.json").read_text()),
                ref=json.loads((tmp / "ref.json").read_text()),
                metrics=tmp / "log_killed" / "metrics.jsonl")


def test_kill_restart_converges_bitwise(kill_runs):
    resumed, ref = kill_runs["resumed"], kill_runs["ref"]
    assert resumed["version"] == ref["version"] >= N_CYCLES
    assert resumed["digest"] == ref["digest"]
    assert resumed["cursor"] == ref["cursor"]
    assert resumed["logits"] == ref["logits"]  # json keeps f32 values exactly
    assert resumed["stats"]["global_step"] == ref["stats"]["global_step"]


def test_record_accounting_no_dup_no_loss(kill_runs, env):
    """The killed and resumed lineages share one metrics.jsonl: across both,
    the durable cycles' spans tile each record exactly once, and the
    records fully trained equal the cursor's count."""
    cycles = online_cycles(kill_runs["metrics"])
    versions = [c["version"] for c in cycles]
    assert len(cycles) >= N_CYCLES and versions == sorted(set(versions))
    spans: dict[int, list] = {}
    for c in cycles:
        for seq, a, b in c["consumed"]:
            spans.setdefault(seq, []).append((a, b))
    rows = {seq: n for (_, seq), n in env["rows"].items()}
    covered = 0
    for seq, parts in spans.items():
        parts.sort()
        assert parts[0][0] == 0, (seq, parts)
        for (_, b0), (a1, _) in zip(parts, parts[1:]):
            assert b0 == a1, f"seq {seq}: gap or overlap at {parts}"
        assert parts[-1][1] <= rows[seq]
        covered += parts[-1][1] == rows[seq]
    assert covered == kill_runs["resumed"]["cursor"]["records"]
    assert sum(b - a for c in cycles for _, a, b in c["consumed"]) == \
        kill_runs["resumed"]["stats"]["global_step"] * BATCH
