"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the CPU.

The reference's three scripts run in one subprocess, each through its own
``__main__`` with the flags given here; the subprocess records the values
they compute at full precision (the quickstart's last step metrics through
a wrapped ``make_sim_train_step``, the served tokens through a wrapped
``ServingEngine.generate``; gossip_vs_agd prints its results as JSON) and
the weights each script draws (through a wrapped ``lm_init``). The port's
``main(argv)`` runs on those weights, bridged in through the example
module's ``lm_init``: final losses within the simulated train
steps' 2e-4 (XLA contracts FMAs in the reference's jitted step), greedy
tokens equal on the reduced fp32 model. The examples take ``--device``,
default cuda, which raises without a card.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.examples import (gossip_vs_agd, quickstart,  # noqa: E402
                                  serve_batched)

ROOT = Path(__file__).resolve().parents[1]
QUICK_STEPS = 3     # the reference's quickstart compiles a step per phase
STEPS = 6
PROTOCOLS = "gossip,gossip_async,agd"
TOL = 2e-4

_SCRIPT = r"""
import contextlib, io, json, pickle, runpy, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import jax, numpy as np
import repro.core, repro.models, repro.serve
quick, steps, protocols = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
weights_path = sys.argv[4]
out = {}
weights = {}

orig_init = repro.models.lm_init
def recording_init(*a, **k):
    params, axes = orig_init(*a, **k)
    weights.setdefault(sys.argv[0], jax.tree.map(np.asarray, params))
    return params, axes
repro.models.lm_init = recording_init

def run(path, argv):
    sys.argv = [path] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    return buf.getvalue()

orig_step = repro.core.make_sim_train_step
def recording(*a, **k):
    step = orig_step(*a, **k)
    def s(*args):
        res = step(*args)
        m = res[-1]
        out["quickstart"] = {"final_loss": float(m["loss"]),
                             "replica_variance": float(m["replica_variance"])}
        return res
    return s
repro.core.make_sim_train_step = recording
out["quickstart_stdout"] = run("examples/quickstart.py", ["--steps", str(quick)])
repro.core.make_sim_train_step = orig_step

text = run("examples/gossip_vs_agd.py", ["--steps", str(steps),
                                         "--protocols", protocols])
out["gossip_vs_agd"] = json.loads(text[text.rindex("\n{") + 1:])

orig_gen = repro.serve.ServingEngine.generate
def generate(self, *a, **k):
    toks = orig_gen(self, *a, **k)
    out["serve_tokens"] = [[int(t) for t in row] for row in toks]
    return toks
repro.serve.ServingEngine.generate = generate
out["serve_stdout"] = run("examples/serve_batched.py", [])
with open(weights_path, "wb") as f:
    pickle.dump(weights, f)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    weights_path = tmp_path_factory.mktemp("ref") / "weights.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(QUICK_STEPS),
                        str(STEPS), PROTOCOLS, str(weights_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    with open(weights_path, "rb") as f:
        out["weights"] = pickle.load(f)
    return out


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _bridge(monkeypatch, reference, module, script):
    """The example module draws the weights the reference's ``script``
    drew (its first ``lm_init``), as port tensors on the CPU."""
    tree = params_from_numpy(reference["weights"][script], device="cpu")
    monkeypatch.setattr(module, "lm_init", lambda *a, **k: tree)


def test_quickstart_matches_the_reference(reference, capsys, monkeypatch):
    _bridge(monkeypatch, reference, quickstart, "examples/quickstart.py")
    got = quickstart.main(["--steps", str(QUICK_STEPS), "--device", "cpu"])
    want = reference["quickstart"]
    assert abs(got["final_loss"] - want["final_loss"]) <= TOL
    assert got["replica_variance"] == pytest.approx(
        want["replica_variance"], rel=1e-2)
    # the same printed summary lines
    printed = capsys.readouterr().out.splitlines()
    ref_lines = reference["quickstart_stdout"].splitlines()
    assert printed[0] == ref_lines[0]          # the schedule line
    assert printed[-1].split()[0] == ref_lines[-1].split()[0] == "final:"
    assert len(printed) == len(ref_lines)


def test_gossip_vs_agd_matches_the_reference(reference, monkeypatch):
    _bridge(monkeypatch, reference, gossip_vs_agd,
            "examples/gossip_vs_agd.py")
    got = gossip_vs_agd.main(
        ["--steps", str(STEPS), "--protocols", PROTOCOLS, "--device", "cpu"])
    want = reference["gossip_vs_agd"]
    assert list(got) == list(want) == PROTOCOLS.split(",")
    for proto in want:
        assert sorted(got[proto]) == sorted(want[proto])
        assert abs(got[proto]["final_loss"]
                   - want[proto]["final_loss"]) <= TOL, proto
        assert got[proto]["replica_variance"] == pytest.approx(
            want[proto]["replica_variance"], rel=1e-2, abs=1e-12), proto


def test_serve_batched_matches_the_reference(reference, capsys,
                                             monkeypatch):
    _bridge(monkeypatch, reference, serve_batched,
            "examples/serve_batched.py")
    got = serve_batched.main(["--device", "cpu"])
    np.testing.assert_array_equal(got["tokens"],
                                  np.asarray(reference["serve_tokens"]))
    printed = capsys.readouterr().out.splitlines()
    ref_lines = reference["serve_stdout"].splitlines()
    assert printed[0] == ref_lines[0] and printed[-1] == ref_lines[-1]


@pytest.mark.parametrize("example", [quickstart, gossip_vs_agd,
                                     serve_batched])
def test_examples_default_to_the_card(example):
    """No fallback: without ``--device cpu`` the examples ask for CUDA and
    raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        example.main(["--steps", "1"] if example is not serve_batched
                     else [])
