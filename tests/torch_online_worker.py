"""Worker of the port's online-loop kill drills (run as a subprocess, not
by pytest).

Usage:
    python torch_online_worker.py <spec_json_path>

Spec keys: ``kw`` (the ``read_configs`` keywords, ``[faults]`` included),
``log_dir``, ``out_json``, ``probe`` (a list of ``[request id, {column:
values}]``).  Runs the port's ``OnlineLoop`` on the CPU; when the loop
drains it scores the probe through the live serving side and writes the
store's version, the current bundle's digest, the replay cursor, the run
stats and the probe logits to ``out_json``.  An injected kill exits with
``KILL_EXIT_CODE`` and writes nothing, as a crashed supervisor does.
"""

import json
import sys
from pathlib import Path


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.serve.export import read_raw_bundle
    from tdfo_tpu_torch.train.online import OnlineLoop

    loop = OnlineLoop(read_configs(None, **spec["kw"]), log_dir=spec["log_dir"],
                      device="cpu")
    try:
        stats = loop.run()
        schema = loop.trainer._eval_schema
        probe = [(rid, {k: np.asarray(v, dtype=schema[k]) for k, v in cols.items()})
                 for rid, cols in spec["probe"]]
        logits = loop.probe(probe)
        manifest, _ = read_raw_bundle(loop.store.current_dir())
        Path(spec["out_json"]).write_text(json.dumps({
            "stats": stats,
            "version": int(loop.store.current_version()),
            "digest": manifest["digest"],
            "cursor": loop.consumer.cursor(),
            "logits": {rid: np.asarray(v).tolist() for rid, v in logits.items()},
        }))
    finally:
        loop.close()


if __name__ == "__main__":
    main()
