"""``examples/robust_training_torch.py`` on the CPU against the reference
example ``examples/robust_training.py``.

The reference runs in a subprocess on 8 fake devices (its (pod 2, data 2,
model 2) mesh: 4 workers); the port's example runs in this process on a
WorkerLayout(2, 2) from the same weights (the reference's seed-0 draw,
carried across by ``repro_torch.convert.params_from_jax``). The reference
prints its losses to 4 decimals, so they are held within the train tests'
1e-5 relative plus half a unit of that last digit.
"""
import dataclasses
import os
import re
import runpy
import subprocess
import sys

import jax
import numpy as np
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
ROW = re.compile(r"^step\s+(\d+)\s+loss\s+(\S+)\s+consensus_spread\s+(\S+)$")


def _reference_rows():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    cmd = [sys.executable, os.path.join(REPO, "examples",
                                        "robust_training.py"),
           "--tiny", "--steps", str(STEPS)]
    for _ in range(2):   # the CPU collective rendezvous may stall once
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, env=env, cwd=REPO)
        if run.returncode == 0 or "rendezvous" not in run.stderr.lower():
            break
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().splitlines()[-1] == "robust_training OK"
    return [(int(m[1]), float(m[2]), float(m[3]))
            for m in map(ROW.match, run.stdout.splitlines()) if m]


def test_tiny_run_matches_the_reference_example(capsys):
    ref = _reference_rows()
    example = runpy.run_path(os.path.join(REPO, "examples",
                                          "robust_training_torch.py"))
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("paper_sim")),
                               attn_impl="naive", dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("paper_sim")),
                               attn_impl="naive", dtype="float32")
    params = params_from_jax(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                jcfg)), tcfg, "cpu")
    rows = example["run"](example["parse_args"](
        ["--tiny", "--steps", str(STEPS), "--device", "cpu"]), params)
    assert [r[0] for r in rows] == [r[0] for r in ref] == list(range(STEPS))
    np.testing.assert_allclose([r[1] for r in rows], [r[1] for r in ref],
                               rtol=1e-5, atol=5e-5)
    assert all(r[2] == 0.0 for r in rows)      # the trim: one aggregate
    out = capsys.readouterr().out
    assert "workers=4 byzantine=(1,)" in out
