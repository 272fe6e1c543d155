"""Port parity of the training mesh: a ``train_step`` over a (data,
model) or (pod, data, model) mesh of gloo processes against the
reference's ``train_step`` on one CPU device and the port's one-rank
step, on the reference's converted parameters and the same numpy
batches.

The gloo runs spawn one process per rank, as
``tests/test_torch_mesh_serving.py`` does (a file store in the test's
tmp dir, one thread each, ``TIMEOUT_S`` a run): one run of 4 ranks
((2, 2), (1, 4), (2, 2) with 2 microbatches, then a (2, 2) checkpoint)
and one of 2 ranks ((1, 2), (2, 1), the pod axis (2, 1, 1), stablelm at
(1, 2), mamba2, paligemma and hubert at (2, 1), qwen3 and qwen3-moe at
(2, 1) with 2 microbatches and a ``loss_mask``, the (2, 2) checkpoint
read back at (1, 2), then ``multihost --mode train``).  Meshes are
(pod, data, model).  Each case shards the reference's state of each of
two steps by ``launch.shardings.train_param_specs`` / ``train_opt_specs``
and gives every rank its rows of the batch; the ranks gather the
gradients and the updated state whole.  The masked microbatch cases
(``MASKED``) are held against the reference's jitted step with the same
microbatches: their mask sums and (qwen3-moe) dispatch groups and
load-balance losses are those of the reference's microbatch i, rows i
of the whole batch, which no rank's own rows hold; each also shows that
the old layout, a rank's microbatches cut from its own rows, misses
that step by more than the tolerance.  The MoE case asserts its router
margins clear of rounding, as ``tests/test_torch_train.py`` does.

Tolerances (``PERF.md`` §2, ROADMAP C):
- loss and metrics within rtol 1e-5, atol 1e-6, the same on every rank;
- every leaf's gradient within ``GRAD_TOL`` = 1e-4 x the leaf's max
  |grad|; the first moments the same of theirs, the second twice that
  (they are squares);
- updated parameters under Adam's first-step rule: within 1e-5 |p| +
  0.02 lr where the reference's (or the one-rank port's) gradient
  clears 100 x ``GRAD_TOL``, else within 2 lr (1 + wd |p|); two steps
  chained on the mesh within the per-step bound summed.

Also: a (1, 1) mesh is bitwise the step without one, every group's
collective bytes equal the analytic count (``_train_bytes``), the
training specs equal the reference's ``tree_shardings`` on layout
meshes, the refusals (ROADMAP A9.3b), and a batch whose rank blocks the
microbatches do not divide is refused.
"""

import math
import os
import subprocess
import sys
import types

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import ShapeConfig  # noqa: E402
from repro.data.synthetic import synthetic_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import shardings as jshardings  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import logical_axes as j_logical_axes  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import init_opt_state as j_init_opt  # noqa: E402
from repro.optim import opt_state_axes as j_opt_state_axes  # noqa: E402
from repro.training import TrainConfig as JTrain  # noqa: E402
from repro.training import train_step as j_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import save  # noqa: E402
from repro_torch.data import ShardedLoader  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import make_train_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import partitioning  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.training import TrainConfig, train_step  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4
ROWS, SEQ = 4, 16
# name -> (arch, (pod, data, model), microbatches, world of its run)
CASES = {
    "q22": ("qwen3-0.6b", (1, 2, 2), 1, 4),
    "q14": ("qwen3-0.6b", (1, 1, 4), 1, 4),
    "q22mb": ("qwen3-0.6b", (1, 2, 2), 2, 4),
    "q12": ("qwen3-0.6b", (1, 1, 2), 1, 2),
    "q21": ("qwen3-0.6b", (1, 2, 1), 1, 2),
    "q211": ("qwen3-0.6b", (2, 1, 1), 1, 2),
    "s12": ("stablelm-1.6b", (1, 1, 2), 1, 2),
    "m21": ("mamba2-780m", (1, 2, 1), 1, 2),
    "p21": ("paligemma-3b", (1, 2, 1), 1, 2),
    "h21": ("hubert-xlarge", (1, 2, 1), 1, 2),
    "q21mbm": ("qwen3-0.6b", (1, 2, 1), 2, 2),
    "moe21mbm": ("qwen3-moe-30b-a3b", (1, 2, 1), 2, 2),
}
# cases whose batches carry a loss_mask, held to the reference's step with
# their microbatches (the others to its whole batch's step)
MASKED = ("q21mbm", "moe21mbm")
# the smallest top-k router margin the MoE case must clear: the two
# packages' router logits differ by rounding (1e-6)
MARGIN = 1e-4
MH_ARGS = ["--mode", "train", "--device", "cpu", "--reduced", "--steps", "2",
           "--batch", str(ROWS), "--seq", str(SEQ)]
# bf16 with remat: the (1, 2) losses against one process's, which differ
# as the model axis sums bf16 partial products that one rank's GEMM sums
# in fp32.  Measured on this file's inputs: 4.8e-4 of a loss near 12.6
MH_LOSS_TOL = 5e-3

_RANK_SCRIPT = r"""
import sys
import threading
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
tmp, names = sys.argv[3], sys.argv[4].split(",")
dist.init_process_group("gloo", init_method="file://%s/store" % tmp,
                        world_size=world, rank=rank)

from repro_torch import configs
from repro_torch.checkpoint import load, save
from repro_torch.launch import multihost, shardings
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import partitioning
from repro_torch.optim import OptimizerConfig, OptState
from repro_torch.training import TrainConfig, train_step
from repro_torch.models.model import lm_loss
from repro_torch.training.train import loss_and_grads
from repro_torch.tree import flatten_with_path, keystr, leaves, unflatten_like

data = torch.load(tmp + "/case.pt")
opt_cfg = OptimizerConfig(**data["opt"])
out = {}


def flat(tree):
    return {keystr(p): v.clone() for p, v in flatten_with_path(tree)}


def whole(tree, specs, mesh):
    return {keystr(p): shardings.gather_leaf(v, spec, mesh)
            for (p, v), spec in zip(flatten_with_path(tree),
                                    partitioning.spec_leaves(specs, tree))}


if world == 4:
    # a (2, 2) checkpoint of the first qwen3 state's blocks, first: the
    # 2-rank run reads it
    cfg = configs.get_reduced("qwen3-0.6b")
    params = data["q22"]["states"][0][0]
    mesh = make_train_mesh(2, 2)
    with partitioning.mesh_context(mesh):
        pspecs = shardings.train_param_specs(mesh, cfg, params)
        save(tmp + "/ckpt22", shardings.local_shard(params, pspecs, mesh),
             shardings=pspecs)
    if rank == 0:
        open(tmp + "/ckpt22.npz.done", "w").close()

for name in names:
    case = data[name]
    pods, d, m = case["mesh"]
    cfg = configs.get_reduced(case["arch"])
    tcfg = TrainConfig(optimizer=opt_cfg, microbatches=case["micro"])
    mesh = make_train_mesh(d, m, multi_pod=pods > 1)
    with partitioning.mesh_context(mesh):
        state = None
        for i in range(2):
            params, mo = case["states"][i]
            opt = OptState(step=mo["step"], mu=mo["mu"], nu=mo["nu"])
            pspecs = shardings.train_param_specs(mesh, cfg, params)
            ospecs = shardings.train_opt_specs(mesh, cfg, opt)
            p = shardings.local_shard(params, pspecs, mesh)
            o = shardings.local_shard(opt, ospecs, mesh)
            n = case["batches"][i]["_rows"] // mesh.fsdp_size()
            k = mesh.fsdp_index()
            b = {key: v[k * n:(k + 1) * n]
                 for key, v in case["batches"][i].items() if key != "_rows"}
            _, _, grads = loss_and_grads(cfg, tcfg, p, b, pspecs)
            out["%s/grads%d" % (name, i)] = whole(grads, pspecs, mesh)
            mesh.reset_bytes()
            new_p, new_o, metrics = train_step(cfg, tcfg, p, o, b, pspecs)
            out["%s/bytes%d" % (name, i)] = mesh.axis_bytes()
            out["%s/metrics%d" % (name, i)] = {
                key: float(v) for key, v in metrics.items()}
            out["%s/params%d" % (name, i)] = whole(new_p, pspecs, mesh)
            out["%s/mu%d" % (name, i)] = whole(new_o.mu, pspecs, mesh)
            out["%s/nu%d" % (name, i)] = whole(new_o.nu, pspecs, mesh)
            # two steps chained on the mesh: the second from the first's
            # own state
            if i == 0:
                state = (new_p, new_o)
            else:
                chained, _, _ = train_step(cfg, tcfg, *state, b, pspecs)
                out["%s/chained" % name] = whole(chained, pspecs, mesh)
        if name == "q12":
            # remat recomputes a block where the autograd engine runs the
            # backward: on the card a device thread of its own, where no
            # mesh context is active.  Its gradients, so run, against the
            # step's without remat
            live = [t.detach().requires_grad_(True) for t in leaves(p)]
            loss, _ = lm_loss(cfg.with_updates(remat=True),
                              unflatten_like(p, live), b)
            got = {}
            worker = threading.Thread(target=lambda: got.update(
                grads=torch.autograd.grad(loss, live)))
            worker.start()
            worker.join()
            _, _, want = loss_and_grads(cfg, tcfg, p, b, pspecs)
            out["remat_thread"] = "grads" in got and all(
                torch.equal(a, c) for a, c in zip(got["grads"],
                                                  leaves(want)))

if world == 2:
    # the (2, 2) checkpoint read back on a (1, 2) mesh: this rank's blocks
    import os
    import time
    deadline = time.monotonic() + 200
    while not os.path.exists(data["ckpt"]["path"] + ".npz.done"):
        assert time.monotonic() < deadline, "no (2, 2) checkpoint"
        time.sleep(0.1)
    cfg = configs.get_reduced("qwen3-0.6b")
    like = data["ckpt"]["like"]
    mesh = make_train_mesh(1, 2)
    with partitioning.mesh_context(mesh):
        pspecs = shardings.train_param_specs(mesh, cfg, like)
        got = load(data["ckpt"]["path"], like, shardings=pspecs)
    want = shardings.local_shard(like, pspecs, mesh)
    out["ckpt_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(got), flatten_with_path(want)))
    out["ckpt_shapes"] = {key: tuple(v.shape) for key, v in flat(got).items()}
dist.destroy_process_group()

if world == 2:
    # multihost --mode train at (1, 2), on the pod axis and on the data
    # axis (each call joins and leaves a process group of its own)
    for tag, extra in (("model", ["--model-par", "2"]),
                       ("pod", ["--multi-pod"]),
                       ("data", ["--model-par", "1"])):
        res = multihost.main(data["mh_args"] + extra + [
            "--coordinator", "file://%s/mh-%s" % (tmp, tag),
            "--num-processes", "2", "--process-id", str(rank)])
        out["mh/" + tag] = res["losses"]
        out["mh/%s/bytes" % tag] = res["step_bytes"]
torch.save(out, "%s/rank%d.pt" % (tmp, rank))
"""


def _spawn(world, tmp, names):
    """Start ``world`` rank processes of ``_RANK_SCRIPT``; returns a
    function that waits for them, fails the test if a rank fails or the
    run outlives TIMEOUT_S (every rank is killed), and returns each
    rank's outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), str(tmp),
         ",".join(names)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            assert p.returncode == 0, \
                f"rank {r} of {world}:\n{logs[r][-3000:]}"
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return wait


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree):
    return {keystr(p): v for p, v in flatten_with_path(tree)}


def _batches(cfg, mask=False):
    """Two batches; with ``mask`` a loss_mask of about 60% ones on each's
    SEQ - 1 targets."""
    shape = ShapeConfig("t", SEQ + cfg.num_patches, ROWS, "train")
    out = [synthetic_batch(cfg, shape, np.random.RandomState(seed))
           for seed in range(2)]
    if mask:
        for seed, b in enumerate(out):
            b["loss_mask"] = (np.random.RandomState(1000 + seed).rand(
                ROWS, SEQ - 1) < 0.6).astype(np.float32)
    return out


def _ref_key(name):
    """The ``references`` of case ``name``: (arch, microbatches, mask)."""
    arch, _, micro, _ = CASES[name]
    return (arch, micro, True) if name in MASKED else (arch, 1, False)


def _old_layout(batch, micro, ranks):
    """``batch`` with its rows permuted so that the reference's
    microbatch i holds what the old layout gave it: rank r's microbatch
    i cut from r's own block of rows."""
    return {k: v.reshape(ranks, micro, -1, *v.shape[1:]).swapaxes(0, 1)
            .reshape(v.shape) for k, v in batch.items()}


@pytest.fixture(scope="module")
def references():
    """Per (arch, microbatches, mask): the reference's batches (with a
    loss_mask if ``mask``), its three states of two jitted steps with
    those microbatches from its seed-0 parameters, and its metrics;
    ``get.steps`` keeps each key's jitted step.  The unmasked microbatch
    case is held to the whole batch's step: a dense model's loss is a
    mean over equal microbatches, so the two are the same function."""
    cache = {}

    def get(arch, micro=1, mask=False):
        key = (arch, micro, mask)
        if key not in cache:
            jc = jconfigs.get_reduced(arch)
            jt = JTrain(optimizer=JOpt(**OPT), microbatches=micro)
            step = jax.jit(lambda p, o, b: j_train_step(jc, jt, p, o, b))
            get.steps[key] = step
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            batches = _batches(configs.get_reduced(arch), mask)
            states, metrics = [(jp, j_init_opt(jp))], []
            with jops.force_kernel("xla"):
                for b in batches:
                    p, o, mtr = step(*states[-1],
                                     jax.tree.map(jnp.asarray, b))
                    states.append((p, o))
                    metrics.append(_np(mtr))
            cache[key] = (batches, [(_np(p), _np(o))
                                    for p, o in states], metrics)
        return cache[key]

    get.steps = {}
    return get


def _state(jstate):
    p, o = jstate
    o = opt_state_from_jax(o, device="cpu")
    return (params_from_jax(p, device="cpu"),
            {"step": o.step, "mu": o.mu, "nu": o.nu})


@pytest.fixture(scope="module")
def mesh_runs(references, tmp_path_factory):
    """{world: the per-rank outputs of its run} of the 4-rank and the
    2-rank runs, side by side (the latter waits for the former's
    checkpoint before reading it), and "ckpt": that checkpoint's
    path."""
    tmps = {world: tmp_path_factory.mktemp(f"world{world}")
            for world in (4, 2)}
    runs = {"ckpt": str(tmps[4] / "ckpt22")}
    waits = {}
    for world, tmp in tmps.items():
        names = [n for n, c in CASES.items() if c[3] == world]
        data = {"opt": OPT, "mh_args": MH_ARGS}
        for name in names:
            arch, mesh, micro, _ = CASES[name]
            batches, states, _ = references(*_ref_key(name))
            data[name] = {
                "arch": arch, "mesh": mesh, "micro": micro,
                "states": [_state(s) for s in states[:2]],
                "batches": [dict({k: torch.from_numpy(v)
                                  for k, v in b.items()}, _rows=ROWS)
                            for b in batches]}
        if world == 2:
            data["ckpt"] = {"path": runs["ckpt"],
                            "like": data["q12"]["states"][0][0]}
        torch.save(data, tmp / "case.pt")
        waits[world] = _spawn(world, tmp, names)
    runs.update({world: wait() for world, wait in waits.items()})
    return runs


def _grads_close(got, want, what, tol=GRAD_TOL):
    """Every leaf of ``got`` within ``tol`` x the max |.| of ``want``'s."""
    assert sorted(got) == sorted(want), what
    worst = 0.0
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[key], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        share = float(np.abs(g - w).max()) / (tol * scale)
        assert share <= 1.0, (what, key, share)
        worst = max(worst, share)
    return worst


def _adam_close(got, want, before, grads, lr, wd, what):
    """Updated parameters: strict where every step's gradient of
    ``grads`` (none: nowhere) clears 100 x GRAD_TOL of its max, else
    within Adam's sign-flip bound 2 lr (1 + wd |p|) a step."""
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        w = np.asarray(w, np.float32)
        p = np.abs(np.asarray(before[key], np.float32))
        strong = np.full(w.shape, bool(grads))
        for step_grads in grads:
            sg = np.abs(np.asarray(step_grads[key], np.float32))
            strong &= sg > 100 * GRAD_TOL * max(float(sg.max()), 1e-30)
        diff = np.abs(g - w)
        assert (diff <= 2 * sum(lr) * (1 + wd * p) + 1e-6).all(), (what, key)
        bad = strong & (diff > 1e-5 * np.abs(w) + 0.02 * max(lr))
        assert not bad.any(), (what, key, float(diff[strong].max()))


def _torch_np(tree):
    return {k: v.detach().float().numpy() for k, v in tree.items()}


def _router_margins(monkeypatch):
    """Every router call of the port from here on records its top-3
    logits (``check`` asserts the smallest top-k margin > MARGIN)."""
    seen = []
    real = tmoe.router_logits

    def record(p, x):
        out = real(p, x)
        seen.append(torch.topk(out.detach().reshape(-1, out.shape[-1]),
                               min(out.shape[-1], 3), dim=-1).values)
        return out

    monkeypatch.setattr(tmoe, "router_logits", record)

    def check(cfg, where):
        k = cfg.experts_per_token
        least = min(float((t[:, k - 1] - t[:, k]).min()) for t in seen)
        print(f"{where}: {len(seen)} router calls, smallest top-{k} margin "
              f"{least:.3g}")
        assert least > MARGIN, where

    return check


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_step_matches_reference(name, references, mesh_runs,
                                     monkeypatch):
    """Both steps of the case, each from the reference's state: loss and
    metrics (the same on every rank), gradients, moments and updated
    parameters against the reference's jitted step and the port's
    one-rank step; then the two steps chained on the mesh."""
    arch, mesh, micro, world = CASES[name]
    batches, states, jmetrics = references(*_ref_key(name))
    ranks = mesh_runs[world]
    cfg = configs.get_reduced(arch)
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), microbatches=micro)
    b1, wd = tcfg.optimizer.b1, tcfg.optimizer.weight_decay
    margins = _router_margins(monkeypatch) if "M" in cfg.layer_pattern \
        else None
    out = ranks[0]
    lrs, ref_grads = [], []
    for i in range(2):
        got = out[f"{name}/metrics{i}"]
        for r, other in enumerate(ranks):
            assert other[f"{name}/metrics{i}"] == got, (name, i, r)
        tp = params_from_jax(states[i][0], device="cpu")
        to = opt_state_from_jax(states[i][1], device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in batches[i].items()}
        _, _, port_g = loss_and_grads(cfg, tcfg, tp, tb)
        port_p, port_o, port_m = train_step(cfg, tcfg, tp, to, tb)
        assert sorted(got) == sorted(jmetrics[i])
        for key, val in got.items():
            np.testing.assert_allclose(val, float(jmetrics[i][key]),
                                       err_msg=f"{name} {i} {key}",
                                       **METRIC_TOL)
            np.testing.assert_allclose(val, float(port_m[key]),
                                       err_msg=f"{name} {i} {key}",
                                       **METRIC_TOL)
        grads = _torch_np(out[f"{name}/grads{i}"])
        _grads_close(grads, _torch_np(_flat(port_g)), f"{name} {i} grads")
        # the reference's clipped gradient, from its first moments
        mu0, mu1 = _jflat(states[i][1].mu), _jflat(states[i + 1][1].mu)
        clipped = {k: (mu1[k] - b1 * mu0[k]) / (1 - b1) for k in mu1}
        scale = min(1.0, 1.0 / (got["grad_norm"] + 1e-9))
        _grads_close({k: v * scale for k, v in grads.items()}, clipped,
                     f"{name} {i} clipped grads")
        ref_grads.append(clipped)
        _grads_close(_torch_np(out[f"{name}/mu{i}"]), mu1, f"{name} {i} mu")
        _grads_close(_torch_np(out[f"{name}/nu{i}"]),
                     _jflat(states[i + 1][1].nu), f"{name} {i} nu",
                     2 * GRAD_TOL)
        before = _jflat(states[i][0])
        lr = float(jmetrics[i]["lr"])
        lrs.append(lr)
        new = _torch_np(out[f"{name}/params{i}"])
        _adam_close(new, _jflat(states[i + 1][0]), before, [clipped], [lr],
                    wd, f"{name} {i} params vs reference")
        _adam_close(new, _torch_np(_flat(port_p)), before,
                    [_torch_np(_flat(port_g))], [lr], wd,
                    f"{name} {i} params vs one rank")
        _grads_close(_torch_np(out[f"{name}/mu{i}"]),
                     _torch_np(_flat(port_o.mu)), f"{name} {i} mu, one rank")
    _adam_close(_torch_np(out[f"{name}/chained"]), _jflat(states[2][0]),
                _jflat(states[0][0]), [], lrs, wd, f"{name} chained")
    if margins is not None:
        margins(cfg, f"{name} one-rank steps")


@pytest.mark.parametrize("name", MASKED)
def test_old_microbatch_layout_is_told_apart(name, references, mesh_runs):
    """The inputs of each masked microbatch case tell the layouts apart:
    the reference's step on the batch permuted into the old layout (each
    rank's microbatches cut from its own rows) misses the right layout's
    clipped gradients, which the mesh's match, by more than GRAD_TOL in
    both steps (the mask sums weigh each microbatch's tokens), and for
    qwen3-moe also its load-balance loss by more than METRIC_TOL."""
    arch, (pods, d, _), micro, world = CASES[name]
    batches, states, _ = references(*_ref_key(name))
    step = references.steps[_ref_key(name)]
    b1 = OptimizerConfig(**OPT).b1
    for i in range(2):
        with jops.force_kernel("xla"):
            _, old_o, old = step(*states[i], jax.tree.map(
                jnp.asarray, _old_layout(batches[i], micro, pods * d)))
        mu0 = _jflat(states[i][1].mu)
        right = {k: (v - b1 * mu0[k]) / (1 - b1)
                 for k, v in _jflat(states[i + 1][1].mu).items()}
        wrong = {k: (v - b1 * mu0[k]) / (1 - b1)
                 for k, v in _jflat(old_o.mu).items()}
        with pytest.raises(AssertionError):
            _grads_close(wrong, right, f"{name} {i} old layout")
        if "M" in configs.get_reduced(arch).layer_pattern:
            got = mesh_runs[world][0][f"{name}/metrics{i}"]
            assert not np.isclose(got["load_balance_loss"],
                                  float(old["load_balance_loss"]),
                                  **METRIC_TOL), (name, i)


def test_microbatches_must_divide_a_ranks_rows():
    """Two microbatches of a batch of 6 rows over 2 ranks (3 a rank): the
    reference's microbatch of 3 rows has no equal block on each rank, so
    the step refuses it before any collective, naming both numbers."""
    cfg = configs.get_reduced("qwen3-0.6b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fake = types.SimpleNamespace(size=2, rank=0)
    mesh = partitioning.Mesh(("data", "model"), (2, 1), 0, {"fsdp": fake})
    batch = {"tokens": torch.zeros((3, SEQ), dtype=torch.int32)}
    with partitioning.mesh_context(mesh):
        specs = shardings.train_param_specs(mesh, cfg, params)
        with pytest.raises(ValueError, match="6 rows.* 2 microbatches"):
            loss_and_grads(cfg, TrainConfig(microbatches=2),
                           shardings.local_shard(params, specs, mesh),
                           batch, specs)


def _layer_bytes(cfg, rows, seq, m):
    """Model-axis bytes of one forward and backward of ``rows`` x ``seq``
    tokens of a dense decoder split ``m`` ways, fp32, by the ring count
    (all-reduce 2 B (m-1)/m, all-gather B (m-1)/m of the output B).
    Forward: the embedding's all-reduce, two a layer (attention out, MLP
    out), the logits' all-gather.  Backward (``ModelGroup.enter``): two
    a layer (x into the heads, x into the MLP), q_norm and k_norm a
    layer, wk and wv a layer where the axis does not divide the
    kv-heads, x into the vocabulary's product."""
    if m == 1:
        return 0.0
    f = (m - 1) / m
    act = rows * seq * cfg.d_model * 4
    ar = act * (1 + 4 * cfg.num_layers + 1)
    if cfg.qk_norm:
        ar += 2 * cfg.num_layers * cfg.head_dim * 4
    if cfg.num_kv_heads % m:
        ar += 2 * cfg.num_layers * cfg.d_model * cfg.num_kv_heads \
            * cfg.head_dim * 4
    return 2 * f * ar + f * rows * seq * cfg.vocab_size * 4


def _train_bytes(cfg, mesh_shape, micro, params, seq, batch):
    """Per-rank bytes of one ``train_step`` on a (pod, data, model) mesh,
    by group: the "fsdp" group gathers each leaf that the batch axes
    shard (its model-local whole B, B (f-1)/f) and reduce-scatters its
    gradient (B / f (f-1): the same), and all-reduces every other leaf's
    gradient (2 B (f-1)/f) and the stacked loss and 4 metrics; with
    microbatches it gathers the whole ``batch`` once ((f-1)/f of its
    bytes), with a loss_mask it all-reduces each microbatch's mask sum
    (fp32), and each MoE layer gathers its (tokens, k) int64 routes
    ((f-1) x a rank's); the "model" group moves ``_layer_bytes`` a
    microbatch; the "world" group the squared norm."""
    pods, d, m = mesh_shape
    f, world = pods * d, pods * d * m
    mesh = partitioning.Mesh(("pod", "data", "model"), mesh_shape)
    specs = shardings.train_param_specs(mesh, cfg, params)
    local = sum(leaf.numel() * 4 / (m if "model" in spec else 1)
                for leaf, spec in zip(_flat(params).values(),
                                      partitioning.spec_leaves(specs,
                                                               params)))
    exchange = sum(v.nbytes for k, v in batch.items() if k != "_rows") \
        * (f - 1) / f if micro > 1 else 0.0
    if "loss_mask" in batch:     # each microbatch's mask sum, fp32
        exchange += micro * 2 * 4 * (f - 1) / f
    routes = cfg.layer_pattern.count("M") * (f - 1) * (ROWS // f) * seq \
        * cfg.experts_per_token * 8
    out = {"model": micro * _layer_bytes(cfg, ROWS // f // micro, seq, m),
           "fsdp": 2 * (f - 1) / f * (local + 5 * 4) + exchange + routes,
           "world": 2 * 4 * (world - 1) / world}
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_bytes_equal_analytic_count(name, references, mesh_runs):
    arch, mesh, micro, world = CASES[name]
    cfg = configs.get_reduced(arch)
    batches, states, _ = references(*_ref_key(name))
    params = params_from_jax(states[0][0], device="cpu")
    seq = batches[0].get("tokens", batches[0].get("frames")).shape[1] \
        + (cfg.num_patches if cfg.modality == "vlm" else 0)
    want = _train_bytes(cfg, mesh, micro, params, seq, batches[0])
    for r, out in enumerate(mesh_runs[world]):
        for i in range(2):
            got = {k: v for k, v in out[f"{name}/bytes{i}"].items() if v}
            assert sorted(got) == sorted(want), (name, r, got, want)
            for k in want:
                assert math.isclose(got[k], want[k], rel_tol=1e-9), \
                    (name, r, k, got[k], want[k])


def test_remat_recomputes_under_the_forwards_mesh(mesh_runs):
    """At model 2, a remat forward differentiated on another thread (as
    the card's autograd engine runs a backward) recomputes its blocks'
    collectives under the forward's mesh: the gradients equal the step's
    without remat."""
    for out in mesh_runs[2]:
        assert out["remat_thread"]


def test_checkpoint_across_meshes(mesh_runs, references, tmp_path):
    """A (2, 2) checkpoint is the one-rank checkpoint (keys, shapes and
    values), and loads on (1, 2) to that mesh's blocks."""
    _, states, _ = references("qwen3-0.6b")
    save(str(tmp_path / "one"), params_from_jax(states[0][0], device="cpu"))
    with np.load(tmp_path / "one.npz") as one, \
            np.load(mesh_runs["ckpt"] + ".npz") as meshed:
        assert sorted(one) == sorted(meshed)
        for key in one:
            np.testing.assert_array_equal(one[key], meshed[key])
    cfg = configs.get_reduced("qwen3-0.6b")
    for out in mesh_runs[2]:
        assert out["ckpt_equal"]
        assert out["ckpt_shapes"]["['embeddings']['embed']"] == (
            cfg.vocab_size // 2, cfg.d_model)


def test_multihost_train_on_gloo(mesh_runs, tmp_path):
    """``multihost --mode train`` (bf16, remat) on 2 processes: at (1, 2)
    its losses within MH_LOSS_TOL of one process's (the same rows), on
    the pod axis (2, 1, 1) equal to the data axis's (2, 1) bitwise (the
    same rows, and the same collectives over the same group); the bytes
    of each step the same on every rank."""
    one = multihost.main(MH_ARGS + ["--coordinator", f"file://{tmp_path}/st",
                                    "--num-processes", "1",
                                    "--process-id", "0"])["losses"]
    ranks = mesh_runs[2]
    for out in ranks:
        assert out["mh/model"] == ranks[0]["mh/model"]
        assert out["mh/pod"] == out["mh/data"]
        assert out["mh/model/bytes"] == ranks[0]["mh/model/bytes"]
    got = ranks[0]["mh/model"]
    print(f"multihost train losses: one process {one}, model 2 {got}")
    assert len(got) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=MH_LOSS_TOL)
    assert ranks[0]["mh/pod"] != ranks[0]["mh/model"]   # other rows


def test_one_rank_mesh_is_bitwise_no_mesh(references, tmp_path):
    """A (1, 1) mesh builds no group, so a step on it is the step without
    one, bit for bit: no gather, no reduction, the same norm."""
    batches, states, _ = references("qwen3-0.6b")
    cfg = configs.get_reduced("qwen3-0.6b")
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    params = params_from_jax(states[0][0], device="cpu")
    plain = train_step(cfg, tcfg, params, init_opt_state(params), tb)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/st",
                            world_size=1, rank=0)
    try:
        mesh = make_train_mesh(1, 1)
        assert mesh.groups == {}
        with partitioning.mesh_context(mesh):
            specs = shardings.train_param_specs(mesh, cfg, params)
            meshed = train_step(cfg, tcfg, params, init_opt_state(params),
                                tb, specs)
    finally:
        dist.destroy_process_group()
    for a, b in zip(flatten_with_path(plain[:2]),
                    flatten_with_path(meshed[:2])):
        assert torch.equal(a[1], b[1]), keystr(a[0])
    assert {k: float(v) for k, v in plain[2].items()} == \
        {k: float(v) for k, v in meshed[2].items()}


def _layout(names, shape):
    """The reference's view of a mesh: what its partitioning reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


LAYOUTS = [(("data", "model"), (4, 2)), (("data", "model"), (2, 4)),
           (("pod", "data", "model"), (2, 2, 2)),
           (("pod", "data", "model"), (2, 4, 1))]


@pytest.mark.parametrize("names,shape", LAYOUTS)
def test_train_specs_equal_reference(names, shape, monkeypatch):
    """``train_param_specs`` and ``train_opt_specs`` against the
    reference's ``tree_shardings`` of ``logical_axes`` and
    ``opt_state_axes`` (its launcher's), on a layout mesh, for every
    family, Mamba2's "S" blocks on the model axis included (their
    head-aligned layout lies beneath the reference's specs)."""
    monkeypatch.setattr(jshardings, "NamedSharding", lambda mesh, spec: spec)
    jmesh, tmesh = _layout(names, shape), partitioning.Mesh(names, shape)
    model, batch = tmesh.size("model"), tmesh.fsdp_size()
    for arch in configs.list_archs():
        tc, jc = configs.get_reduced(arch), jconfigs.get_reduced(arch)
        params = init_params(tc, torch.Generator().manual_seed(0), "cpu")
        opt = init_opt_state(params)
        shaped = jax.tree.map(lambda t: types.SimpleNamespace(
            shape=tuple(t.shape)), {"p": params, "o": tuple(opt)})
        jaxes = j_logical_axes(jc)
        want_p = jshardings.tree_shardings(jmesh, jaxes, shaped["p"])
        want_o = jshardings.tree_shardings(
            jmesh, j_opt_state_axes(jaxes), type(j_init_opt({}))(
                *shaped["o"]))
        got_p = shardings.train_param_specs(tmesh, tc, params)
        got_o = shardings.train_opt_specs(tmesh, tc, opt)
        for got, want, tree in ((got_p, want_p, params),
                                (got_o, want_o, opt)):
            flat_want = [tuple(w) for w in jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))]
            assert partitioning.spec_leaves(got, tree) == flat_want, arch
    assert batch > 1 or model > 1


def test_refusals():
    """No family is refused on the training mesh: Mamba2 and zamba2 (since
    A9.3b, ``tests/test_torch_ssm_axes.py``), the MoE layer and the
    frontends take their specs on the model axis, and the MoE layer on a
    split batch (its routing gather, ``tests/test_torch_moe_axes.py``):
    the launcher gets as far as asking for their processes."""
    model2 = partitioning.Mesh(("data", "model"), (1, 2))
    data2 = partitioning.Mesh(("pod", "data", "model"), (2, 1, 1))
    for arch in ("mamba2-780m", "zamba2-1.2b", "qwen3-moe-30b-a3b",
                 "grok-1-314b", "paligemma-3b", "hubert-xlarge"):
        cfg = configs.get_reduced(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for mesh in (model2, data2):
            specs = shardings.train_param_specs(mesh, cfg, params)
            assert len(partitioning.spec_leaves(specs, params)) == len(
                _flat(params))
        with pytest.raises(RuntimeError, match="process group"):
            tlaunch.run(arch, True, 1, 4, 16, 1, 2, 3e-3, 1, None,
                        device="cpu")
    for arch in ("qwen3-moe-30b-a3b", "grok-1-314b"):
        with pytest.raises(RuntimeError, match="process group"):
            tlaunch.run(arch, True, 1, 4, 16, 2, 1, 3e-3, 1, None,
                        device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tlaunch.run("qwen3-0.6b", True, 1, 4, 16, 1, 2, 3e-3, 1, None,
                    device="cpu")


def test_loader_stages_this_ranks_rows():
    """``ShardedLoader(mesh=)``: every rank draws the same global batch
    and stages its block of the rows over ("pod", "data") row-major, the
    rows ``PartitionSpec(("pod", "data"))`` puts on it; the model axis
    does not split them."""
    batch = {"tokens": np.arange(16 * 3).reshape(16, 3)}
    for rank in range(8):
        mesh = partitioning.Mesh(("pod", "data", "model"), (2, 2, 2), rank)
        block = 2 * mesh.coord("pod") + mesh.coord("data")
        got = next(ShardedLoader(iter([batch]), device="cpu", prefetch=1,
                                 mesh=mesh))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      batch["tokens"][4 * block:
                                                      4 * block + 4])
    with pytest.raises(ValueError, match="split"):
        next(ShardedLoader(iter([{"tokens": np.zeros((6, 2))}]),
                           device="cpu", prefetch=1, mesh=mesh))
