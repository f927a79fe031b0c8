"""The slice as a whole: the port's packed gossip train step against the
reference's ``make_train_step_bundle``.

* dp=4: the reference runs at mesh (1, 4, 1) in a subprocess with four
  forced host devices, fused and ``fused_update=False``, for 4 steps (one
  full period of the dp=4 dissemination schedule); the port's ``Trainer``
  runs 4 stacked replicas on the CPU from the bridged init. Losses and final
  buckets agree within the reference's end-to-end tolerance (rtol = atol =
  2e-4, tests/test_hier_packed.py:417).
* dp=1 in process, fused (alpha = 0).
* The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.
* An entry point called without ``device`` on a machine without CUDA raises.
"""
import ast
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import sgd, step_decay  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)

ROOT = Path(__file__).resolve().parents[1]
D_MODEL, SEQ, GLOBAL_B, STEPS, LR, EVERY, WD = 64, 16, 8, 4, 0.3, 2, 1e-4
TOL = dict(rtol=2e-4, atol=2e-4)

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={dp}"
import repro
import dataclasses
import jax, numpy as np
from repro.configs import get_config
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh({dp}, 1), "replica")
assert dist.dp == {dp}
opt = sgd(step_decay({lr}, 0.1, {every}), momentum=0.9, weight_decay={wd})
ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}}
for fused in (True, False):
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol="gossip", remat=False, gossip_packed=True,
        fused_update=fused)
    assert bundle.fused == fused
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                packed=True, layout=bundle.layout)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards={dp},
                             batch_per_shard={gb} // {dp}, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run({steps})
    out[fused] = {{
        "loss": [h["loss"] for h in hist],
        "buckets": [np.asarray(b) for b in tr.state["params"].buckets],
        "mom": [np.asarray(b) for b in tr.state["opt"]["mom"].buckets],
    }}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _port_cfg():
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=D_MODEL),
                               param_dtype="float32", compute_dtype="float32")


def _port_run(init_tree, dp, fused):
    cfg = _port_cfg()
    opt = sgd(step_decay(LR, 0.1, EVERY), momentum=0.9, weight_decay=WD)
    bundle = make_train_step_bundle(cfg, opt, dp=dp, protocol="gossip",
                                    gossip_packed=True, fused_update=fused,
                                    device="cpu")
    assert bundle.fused == fused
    params = params_from_numpy(init_tree, layout=bundle.layout, lead=(dp,),
                               device="cpu")
    state = init_train_state(cfg, opt, dp=dp, packed=True,
                             layout=bundle.layout, params=params, device="cpu")
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=dp,
                             batch_per_shard=GLOBAL_B // dp, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(STEPS)
    return ([h["loss"] for h in hist], tr.state["params"].buckets,
            tr.state["opt"]["mom"].buckets, tr.state["opt"]["step"])


@pytest.fixture(scope="module")
def reference_dp4(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(dp=4, d=D_MODEL, lr=LR, every=EVERY, wd=WD,
                               seq=SEQ, gb=GLOBAL_B, steps=STEPS)
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dp4_trajectory_matches_reference(reference_dp4, fused):
    want = reference_dp4[fused]
    losses, buckets, moms, step = _port_run(reference_dp4["init"], 4, fused)
    assert step == STEPS
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    for got, ref in zip(buckets, want["buckets"]):
        np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    for got, ref in zip(moms, want["mom"]):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_fused_and_unfused_differ_at_dp4(reference_dp4):
    """The fused engine mixes with the partner's pre-update params (the
    GoSGD-style combined update), so at dp > 1 its trajectory is not the
    unfused one — in both packages."""
    a = np.asarray(reference_dp4[True]["loss"])
    b = np.asarray(reference_dp4[False]["loss"])
    assert a[0] == b[0] and not np.allclose(a[1:], b[1:], rtol=0, atol=1e-7)


def test_dp1_matches_reference_in_process():
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.data import ShardedTokenDataset as RefDataset
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.specs import train_input_specs
    from repro.models import lm_init as ref_lm_init
    from repro.models import reduced as ref_reduced
    from repro.optim import sgd as ref_sgd
    from repro.optim import step_decay as ref_step_decay
    from repro.train import Trainer as RefTrainer
    from repro.train import init_train_state as ref_init_state
    from repro.train import make_distribution
    from repro.train import make_train_step_bundle as ref_bundle

    cfg = dataclasses.replace(ref_reduced(ref_get_config("qwen3-0.6b"),
                                          d_model=D_MODEL),
                              param_dtype="float32", compute_dtype="float32")
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    opt = ref_sgd(ref_step_decay(LR, 0.1, EVERY), momentum=0.9,
                  weight_decay=WD)
    ss, sa, bs = train_input_specs(cfg, dist, SEQ, 2, opt)
    bundle = ref_bundle(cfg, dist, opt, state_shapes=ss, state_axes=sa,
                        batch_shapes=bs, protocol="gossip", remat=False,
                        gossip_packed=True)
    assert bundle.fused
    state, _ = ref_init_state(jax.random.key(0), cfg, dist, opt, packed=True,
                              layout=bundle.layout)
    ds = RefDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=1,
                    batch_per_shard=2, seed=0)
    tr = RefTrainer(bundle, state, ds, log_every=0)
    want = [h["loss"] for h in tr.run(3)]
    init = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0), cfg)[0])
    del jnp

    pcfg = _port_cfg()
    popt = sgd(step_decay(LR, 0.1, EVERY), momentum=0.9, weight_decay=WD)
    pb = make_train_step_bundle(pcfg, popt, dp=1, gossip_packed=True,
                                device="cpu")
    assert pb.fused and pb.protocol.schedule is None
    pstate = init_train_state(pcfg, popt, dp=1, packed=True, layout=pb.layout,
                              params=params_from_numpy(init, layout=pb.layout,
                                                       lead=(1,), device="cpu"),
                              device="cpu")
    pds = ShardedTokenDataset(vocab=pcfg.vocab, seq_len=SEQ, n_shards=1,
                              batch_per_shard=2, seed=0)
    ptr = Trainer(pb, pstate, pds, log_every=0)
    got = [h["loss"] for h in ptr.run(3)]
    np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(ptr.state["params"].buckets, tr.state["params"].buckets):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def _launch_ranks(argv, world: int) -> dict:
    """The launcher's final JSON line from ``world`` processes of
    ``python -m repro_torch.launch.train argv`` joined as ``torchrun``
    joins them (gloo on localhost); every wait has a time limit."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_launcher_runs_and_refuses_unported_meshes(capsys, monkeypatch):
    """Every --smoke-mesh runs stacked on one device (POD x DATA replicas
    in replica mode, the model axis a shard-local layout under --packed)
    and --multi-pod is ignored there, as in the reference. Under
    WORLD_SIZE > 1 the per-leaf engine with in-replica shards runs, each
    rank holding its piece of every leaf (its losses the stacked
    launcher's within 2e-4), and a WORLD_SIZE other than the mesh's
    positions is refused before any rendezvous."""
    from repro_torch.launch.train import main
    small = ["--steps", "2", "--seq-len", "8", "--global-batch", "4",
             "--d-model", "32", "--log-every", "0", "--device", "cpu"]
    main(["--smoke", "--packed", "--smoke-mesh", "1,2,1", *small])
    assert '"fused": true' in capsys.readouterr().out
    main(["--smoke", "--packed", "--smoke-mesh", "2,2,1", *small])
    assert '"dp": 4, "num_shards": 1' in capsys.readouterr().out
    main(["--smoke", "--multi-pod", *small])
    assert '"dp": 1' in capsys.readouterr().out
    leaf = ["--smoke", "--smoke-mesh", "1,2,2", *small]
    main(leaf)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = _launch_ranks(leaf, 4)
    assert (got["dp"], got["num_shards"], got["packed"]) == (2, 2, False)
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        main(["--smoke", "--packed", "--smoke-mesh", "1,2,2", *small])


def _on_port_fields(ref, port):
    """The reference's config value cut down to the fields the port's
    config has (the port's configs leave out the families it has not
    ported yet)."""
    if isinstance(port, dict):
        return {k: _on_port_fields(ref[k], v) for k, v in port.items()}
    if isinstance(port, (list, tuple)) and len(port) == len(ref):
        return type(port)(_on_port_fields(r, v) for r, v in zip(ref, port))
    return ref


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--d-model", "64"]])
def test_launcher_model_is_the_references_one_device_model(argv):
    """The reference reduces the model under --smoke or on one device
    (src/repro/launch/train.py:104-107); the port's replicas share one
    device, so its launcher reduces qwen3-0.6b with or without --smoke."""
    from repro.configs import get_config as ref_get_config
    from repro.models import reduced as ref_reduced
    from repro_torch.launch.train import model_config, parse_args
    args = parse_args(["--arch", "qwen3-0.6b", "--device", "cpu", *argv])
    port = dataclasses.asdict(model_config(args))
    ref = dataclasses.asdict(dataclasses.replace(
        ref_reduced(ref_get_config("qwen3-0.6b"), d_model=args.d_model),
        param_dtype="float32", compute_dtype="float32"))
    assert len(port["blocks"]) == 2 and port["d_model"] == args.d_model
    assert _on_port_fields(ref, port) == port


# ---------------------------------------------------------------- contract

def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = {m for m in _imported_roots(f) if m in ("jax", "jaxlib", "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    """Default device is cuda: with no card an entry point raises rather
    than carrying on silently on the CPU."""
    from repro_torch.models import lm_init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg()
    opt = sgd(0.1)
    for call in (lambda: lm_init(cfg),
                 lambda: make_train_step_bundle(cfg, opt, dp=2,
                                                gossip_packed=True),
                 lambda: init_train_state(cfg, opt, dp=2, packed=True),
                 lambda: params_from_numpy({"w": np.zeros(3, np.float32)})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
