"""Port parity of the training stack: ``repro_torch.training.train_step``
against the reference's jitted ``train_step`` on reduced qwen3, qwen3-moe,
mamba2 and paligemma, on the reference's own parameters and the same
numpy batches; microbatch accumulation, remat, a falling loss, and the
launcher on the CPU.

Tolerances:
- loss and metrics within rtol 1e-5, atol 1e-6, as the models' losses
  (``tests/test_torch_model.py``): the same fp32 model, summed in
  another order;
- gradients within rtol 1e-4 and ``GRAD_ATOL`` = 1e-5 x the leaf's max
  |grad| (the backward adds the forward's rounding through every layer);
  the optimizer's moments, being linear in the clipped gradients, the
  same;
- updated parameters: Adam's step is mhat / (sqrt(vhat) + eps), about
  g / |g| at the first step, so an element whose gradient sits at
  rounding level can move by +lr in one package and -lr in the other
  (ROADMAP C, "Adam's first step"). Where every step's reference
  gradient clears 100 x ``GRAD_ATOL`` the direction agrees to 1%, and
  the parameters are held within rtol 1e-5, atol 0.02 lr; elsewhere
  within 2 lr (1 + wd |p|) a step.

Multi-step runs are held step by step: each of the three steps starts
both packages from the reference's parameters and optimizer state (the
port's converted by ``params_from_jax`` / ``opt_state_from_jax``), which
also holds the step counter and moments the port reads back.  The port's
own three-step trajectory is held within the per-step bound summed.
MoE routes are discrete: every router call's smallest top-k margin is
asserted above ``MARGIN`` (printed with ``-s``), as in
``tests/test_torch_moe.py``.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import ShapeConfig  # noqa: E402
from repro.data.synthetic import synthetic_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import init_opt_state as j_init_opt  # noqa: E402
from repro.training import TrainConfig as JTrain  # noqa: E402
from repro.training import train_step as j_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.training import TrainConfig, train_step  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-0.6b", "qwen3-moe-30b-a3b", "mamba2-780m", "paligemma-3b"]
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
MARGIN = 1e-4
STEPS = 3


def _batch(cfg, seed=0):
    shape = ShapeConfig("t", 16 + cfg.num_patches, 2, "train")
    return synthetic_batch(cfg, shape, np.random.RandomState(seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cases():
    """Per arch: configs, reference params, batches, the reference's
    jitted step and its three steps' states (teacher forcing)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            jt = JTrain(optimizer=JOpt(**OPT))
            step = jax.jit(lambda p, o, b: j_train_step(jc, jt, p, o, b))
            batches = [_batch(tc, seed) for seed in range(STEPS)]
            states = [(jp, j_init_opt(jp))]
            metrics = []
            with jops.force_kernel("xla"):
                for b in batches:
                    p, o, m = step(*states[-1], jax.tree.map(jnp.asarray, b))
                    states.append((p, o))
                    metrics.append(_np(m))
            cache[arch] = (jc, tc, batches, [(_np(p), _np(o))
                                             for p, o in states], metrics)
        return cache[arch]

    return get


@pytest.fixture
def margins(monkeypatch):
    """Every router call of the port records its smallest top-k margin."""
    seen = []
    real = tmoe.router_logits

    def record(p, x):
        out = real(p, x)
        top = torch.topk(out.detach().reshape(-1, out.shape[-1]),
                         min(out.shape[-1], 3), dim=-1).values
        seen.append(top)
        return out

    monkeypatch.setattr(tmoe, "router_logits", record)

    def check(cfg, where):
        if not seen:
            return
        k = cfg.experts_per_token
        least = min(float((t[:, k - 1] - t[:, k]).min()) for t in seen)
        print(f"{where}: {len(seen)} router calls, smallest top-{k} margin "
              f"{least:.3g}")
        assert least > MARGIN

    return check


def _flat(tree):
    return {keystr(p): v for p, v in flatten_with_path(tree)}


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _adam_close(got, want, before, grads, lr, wd):
    """Updated parameters against the reference's: strict where every
    step's reference gradient clears 100 x its tolerance, else within the
    sign-flip bound 2 lr (1 + wd |p|) a step."""
    for key, w in want.items():
        g = got[key].float().numpy()
        w = w.astype(np.float32)
        p = np.abs(before[key].astype(np.float32))
        strong = np.ones(w.shape, bool)
        for step_grads in grads:
            sg = np.abs(step_grads[key].astype(np.float32))
            strong &= sg > 100 * GRAD_ATOL * max(float(sg.max()), 1e-30)
        diff = np.abs(g - w)
        bound = 2 * sum(lr) * (1 + wd * p)
        assert (diff <= bound + 1e-6).all(), key
        strict = 1e-5 * np.abs(w) + 0.02 * max(lr)
        bad = strong & (diff > strict)
        assert not bad.any(), (key, float(diff[strong].max()),
                               int(strong.sum()))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, cases, margins):
    """One step from the reference's parameters: loss, metrics, gradients
    (held against the moments' difference, which is the reference's
    clipped gradient), updated parameters and the optimizer state; then
    the second and third steps, each from the reference's state."""
    jc, tc, batches, states, jmetrics = cases(arch)
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
    b1 = tcfg.optimizer.b1
    for i, batch in enumerate(batches):
        (jp0, jo0), (jp1, jo1) = states[i], states[i + 1]
        tp = params_from_jax(jp0, device="cpu")
        to = opt_state_from_jax(jo0, device="cpu")
        new_p, new_o, m = train_step(tc, tcfg, tp, to, _torch_batch(batch))
        assert sorted(m) == sorted(jmetrics[i])
        for key, val in m.items():
            np.testing.assert_allclose(float(val), float(jmetrics[i][key]),
                                       err_msg=key, **METRIC_TOL)
        # the reference's clipped gradient, from its first moments
        mu0, mu1 = _jflat(jo0.mu), _jflat(jo1.mu)
        clipped = {k: (mu1[k] - b1 * mu0[k]) / (1 - b1) for k in mu1}
        if i == 0:       # the raw gradients, clipped by the reference's norm
            _, _, grads = loss_and_grads(tc, tcfg, tp, _torch_batch(batch))
            scale = min(1.0, 1.0 / (float(jmetrics[i]["grad_norm"]) + 1e-9))
            for key, g in _flat(grads).items():
                _grad_close(g * scale, clipped[key], key)
        for tree, jtree in ((new_o.mu, jo1.mu), (new_o.nu, jo1.nu)):
            for key, val in _flat(tree).items():
                _grad_close(val, _jflat(jtree)[key], key)
        assert int(new_o.step) == int(jo1.step) == i + 1
        lr = float(jmetrics[i]["lr"])
        _adam_close(_flat(new_p), _jflat(jp1), _jflat(jp0), [clipped], [lr],
                    tcfg.optimizer.weight_decay)
    margins(tc, f"{arch} train steps")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m"])
def test_own_trajectory_stays_within_the_bound(arch, cases):
    """The port's own three steps, from the reference's initial state."""
    jc, tc, batches, states, jmetrics = cases(arch)
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
    tp = params_from_jax(states[0][0], device="cpu")
    to = init_opt_state(tp)
    for batch in batches:
        tp, to, m = train_step(tc, tcfg, tp, to, _torch_batch(batch))
    lrs = [float(m["lr"]) for m in jmetrics]
    grads = [{k: np.zeros_like(v) for k, v in _jflat(states[0][0]).items()}]
    _adam_close(_flat(tp), _jflat(states[-1][0]), _jflat(states[0][0]),
                grads, lrs, tcfg.optimizer.weight_decay)
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics[-1]["loss"]),
                               rtol=1e-3)


def test_microbatches_match_the_full_batch():
    """4 microbatches of 2 against one batch of 8: loss and gradients
    (fp32 accumulation) within the gradient tolerance, metrics averaged."""
    tc = configs.get_reduced("qwen3-0.6b")
    params = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(synthetic_batch(
        tc, ShapeConfig("t", 16, 8, "train"), np.random.RandomState(1)))
    l1, m1, g1 = loss_and_grads(tc, TrainConfig(microbatches=1), params,
                                batch)
    l4, m4, g4 = loss_and_grads(tc, TrainConfig(microbatches=4), params,
                                batch)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    np.testing.assert_allclose(float(m4["ce_loss"]), float(m1["ce_loss"]),
                               rtol=1e-5)
    for key, g in _flat(g4).items():
        assert g.dtype == torch.float32
        _grad_close(g, _flat(g1)[key].numpy(), key)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_remat_matches_no_remat(arch):
    """Checkpointed blocks (the "G" block too) give the same gradients."""
    tc = configs.get_reduced(arch)
    params = init_params(tc, torch.Generator().manual_seed(1), "cpu")
    batch = _torch_batch(_batch(tc, 2))
    tcfg = TrainConfig()
    l0, _, g0 = loss_and_grads(tc, tcfg, params, batch)
    l1, _, g1 = loss_and_grads(dataclasses.replace(tc, remat=True), tcfg,
                               params, batch)
    assert float(l1) == float(l0)
    for key, g in _flat(g1).items():
        _grad_close(g, _flat(g0)[key].numpy(), key)


def test_loss_falls_over_30_steps():
    tc = configs.get_reduced("qwen3-0.6b")
    history = []
    tlaunch.run("qwen3-0.6b", True, 30, 8, 32, 1, 1, 3e-3, 1, None,
                log_every=100, device="cpu", history=history)
    losses = [h["loss"] for h in history]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert history[0]["lr"] == pytest.approx(3e-3 / 20)
    assert tc.vocab_size == 512


def test_launcher_writes_a_checkpoint_the_reference_reads(tmp_path, capsys):
    tlaunch.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                  "--steps", "3", "--batch", "2", "--seq", "16",
                  "--ckpt-dir", str(tmp_path), "--seed", "2"])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "step     2  loss" in out
    assert f"saved checkpoint to {tmp_path}" in out
    assert jckpt.latest_step(str(tmp_path)) == 3
    jc = jconfigs.get_reduced("qwen3-0.6b")
    like = j_init_params(jc, jax.random.PRNGKey(0))
    restored = jckpt.load(jckpt.step_path(str(tmp_path), 3), like)
    assert jckpt.load_metadata(jckpt.step_path(str(tmp_path), 3)) == {
        "arch": jc.name, "steps": 3}
    for key, val in _jflat(restored).items():
        assert val.shape == _jflat(like)[key].shape and np.isfinite(val).all()


def test_launcher_refusals(capsys, tmp_path):
    """What the launchers refuse, and what they run: ``--data-par 2`` as
    two gloo processes, ``multihost --mode train`` on one.  The model
    axis of a Mamba2 arch runs since A9.3b: the launcher gets as far as
    asking for its processes; a mesh without its processes is
    refused."""
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        with pytest.raises(RuntimeError, match="process group"):
            tlaunch.run(arch, True, 1, 2, 16, 1, 2, 3e-3, 1, None,
                        device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tlaunch.run("qwen3-0.6b", True, 1, 2, 16, 2, 1, 3e-3, 1, None,
                    device="cpu")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--device", "cpu", "--data-par", "2", "--steps", "2", "--batch",
           "4", "--seq", "16", "--coordinator", f"file://{tmp_path}/store",
           "--process-id"]
    procs = [subprocess.Popen(cmd + [str(r)], env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "step     0  loss" in logs[0] and "step     1  loss" in logs[0]
    assert "loss" not in logs[1]                 # rank 0 alone reports
    res = multihost.main(["--coordinator", f"file://{tmp_path}/store1",
                          "--num-processes", "1", "--process-id", "0",
                          "--mode", "train", "--device", "cpu", "--reduced",
                          "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert "step 0: loss" in capsys.readouterr().out
