"""Port parity of the MoE layer and the frontends on the mesh (ROADMAP
A9.3, first part): the MoE layer with its batch split over "worker",
"pod" and "data" and its experts (or their hidden units) split over
"model", and the vlm and audio frontends on a model axis.

The MoE layer's dispatch groups, capacity and each token's place in its
expert's buffer follow the whole batch's tokens (the reference runs it
under GSPMD, where the shardings only choose a layout).  A rank of a
split batch therefore all-gathers its top-k expert indices over the
batch groups in block order (``moe.whole_routes``) and keeps its own
rows of the whole batch's dispatch.  Every case here binds the capacity
(a capacity factor of 1) and most skew the routing (the router leans to
experts 0 and 1), so that a wrong group or capacity changes what is
dropped.

The gloo runs spawn one process per rank, as
``tests/test_torch_train_mesh.py`` does (a file store in the test's tmp
dir, one thread each, ``TIMEOUT_S`` a run), three runs at once: 2, 3
and 4 ranks.  Cases:
- ``moe_block`` of one layer of reduced qwen3-moe-30b-a3b on (data 2)
  with a padding row (5 streams padded to 6), (worker 2, data 2) with
  groups that straddle the ranks' blocks, (worker 3) at the multihost
  decode step's 72 streams, and on (model 2) with the experts split,
  (model 2) with every expert's hidden units split (3 experts), (model
  4): each rank's rows, aux losses and dropped fraction against the
  reference's ``moe_block`` on the whole input; routes held exactly,
  the smallest top-k margin asserted clear of rounding; collective
  bytes by group and op against ``_block_bytes``.  First, the fault:
  a worker's block run alone (the per-worker path before the routing
  gather) differs from the whole batch's rows.
- one ``loss_and_grads`` of reduced qwen3-moe at (data, model) = (2, 1)
  and (1, 2), with the reference's aux weight and with one that makes
  the aux losses dominate the router's gradient, and of reduced
  hubert-xlarge and paligemma-3b at (1, 2): loss, metrics and every leaf's gradient
  against the one-rank port step and (qwen3-moe) the reference's
  ``jax.grad`` of ``lm_loss``; and the (2, 1) step with 2
  microbatches against the one-rank step with 2 microbatches.
- serving: reduced qwen3-moe's batch E=1 round and slot pool on (data
  2, model 2), its batch round on (model 4) (2 kv-heads: the
  cache-length split) and its worker-major batch round on (worker 2);
  paligemma's batch round and hubert's ``coded_prefill`` at model 2;
  each against the port with no mesh on the same weights and inputs.

Tolerances: outputs and losses within rtol 1e-5, atol 1e-5 (fp32, the
CPU); decoded logits within ``LOGITS_TOL``; gradients within
``GRAD_TOL`` x each leaf's max |grad| (``tests/test_torch_train_mesh.py``).
"""

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

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import ShapeConfig  # noqa: E402
from repro.data.synthetic import synthetic_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import shardings as jshardings  # noqa: E402
from repro.models import abstract_params as j_abstract  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import logical_axes as j_logical_axes  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import partitioning as jpart  # noqa: E402
from repro.models.model import lm_loss as j_lm_loss  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import shardings as tshardings  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import partitioning as tpart  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training import TrainConfig  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
MOE = "qwen3-moe-30b-a3b"
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = 1e-4
ROWS, SEQ = 4, 16
# the smallest top-k router margin that the block cases must clear: the
# two packages' router logits differ by rounding (1e-6), so every route
# past this margin is the same in both
MARGIN = 1e-4
# name -> (axes, shape, world of its run, rows, sequence, config updates);
# "pad": the last row repeats row 0, as the serving steps pad
BLOCKS = {
    "d2": (("data", "model"), (2, 1), 2, 6, 8, {}),
    "m2_experts": (("data", "model"), (1, 2), 2, 4, 8, {}),
    "m2_ffn": (("data", "model"), (1, 2), 2, 4, 8, {"num_experts": 3}),
    "w3": (("worker", "model"), (3, 1), 3, 72, 1, {}),
    "w2d2": (("worker", "data", "model"), (2, 2, 1), 4, 12, 8, {}),
    "m4": (("data", "model"), (1, 4), 4, 4, 8, {}),
}
PADDED = {"d2"}
# name -> (arch, (data, model), aux weight)
TRAINS = {
    "t21": (MOE, (2, 1), 0.01),
    "t12": (MOE, (1, 2), 0.01),
    "t12_aux": (MOE, (1, 2), 10.0),
    "h12": ("hubert-xlarge", (1, 2), 0.01),
    "p12": ("paligemma-3b", (1, 2), 0.01),
}
# name -> (arch, (data, model), microbatches): two steps of
# ``launch.train.run``
LAUNCHES = {"l_grok12": ("grok-1-314b", (1, 2), 1),
            "l_moe21": (MOE, (2, 1), 1), "l_moe21mb": (MOE, (2, 1), 2)}
# name -> (arch, axes, shape, world, (K, S, E, groups), worker-major,
# pool)
SERVES = {
    "s_w2": (MOE, ("worker", "model"), (2, 1), 2, (2, 2, 1, 2), True, False),
    "s_pali": ("paligemma-3b", ("data", "model"), (1, 2), 2, (2, 2, 1, 1),
               False, False),
    "s_hubert": ("hubert-xlarge", ("data", "model"), (1, 2), 2,
                 (2, 2, 1, 1), False, False),
    "s_d2m2": (MOE, ("data", "model"), (2, 2), 4, (2, 2, 1, 2), False,
               False),
    "s_d2m2_pool": (MOE, ("data", "model"), (2, 2), 4, (2, 2, 1, 2), False,
                    True),
    "s_m4": (MOE, ("data", "model"), (1, 4), 4, (2, 2, 1, 2), False, False),
}
PLEN, STEPS, FRAMES, TEXT = 8, 2, 12, 6
MAX_LEN = 16                       # a 4-way model axis splits its ring
FRONT_MAX_LEN = 28                 # paligemma: 16 patches + 6 text + 2
STRAGGLER, ATTACKER = 6, 1
CF1 = {"capacity_factor": 1.0}

# The serving calls, run on a mesh by the ranks and with no mesh here.
_CALLS = r'''
import numpy as np
import torch


def serve_calls(cfg, coding_args, params, inp, wm, pool, max_len):
    """Each call's (logits, located) of the batch round (a prefill and
    the decode steps of ``inp``) or of the slot pool with every slot
    admitted, on the active mesh if any."""
    from repro_torch.core.berrut import CodingConfig
    from repro_torch.launch.worker_mesh import WorkerShardConfig
    from repro_torch.serving import coded_serving as cs
    k, s, e, g = coding_args
    coding = CodingConfig(k=k, s=s, e=e)
    wshard = (WorkerShardConfig(gather_width=coding.num_workers) if wm
              else None)
    kw = dict(straggler_mask=inp["mask"], byz_mask=inp["byz"],
              byz_noise=inp["noise"], byz_sigma=10.0, with_report=True,
              wshard=wshard)
    out = []
    if not pool:
        logits, state, rep = cs.coded_prefill(cfg, coding, params,
                                              inp["prompt"], max_len, **kw)
        out.append((logits, rep[0]))
        for toks in inp["steps"]:
            logits, state, rep = cs.coded_decode_step(
                cfg, coding, params, state, toks, **kw)
            out.append((logits, rep[0]))
        return out
    state = cs.init_pool_state(cfg, coding, g, max_len, "cpu",
                               wshard=wshard)
    fresh = cs.init_caches(cfg, cs.pool_streams(coding, g, wshard), max_len,
                           torch.float32, "cpu")
    live = np.ones((g,), np.float32)
    logits, state, rep = cs.coded_pool_prefill(
        cfg, coding, params, state, inp["prompt"], live, fresh, **kw)
    out.append((logits, rep[0]))
    for toks in inp["steps"]:
        logits, state, rep = cs.coded_pool_decode_step(
            cfg, coding, params, state, toks, live, **kw)
        out.append((logits, rep[0]))
    return out
'''
_NS: dict = {}
exec(_CALLS, _NS)
serve_calls = _NS["serve_calls"]

# One rank of a gloo run.  argv: rank, world, tmp dir.
_RANK_SCRIPT = _CALLS + r'''
import sys

import torch.distributed as dist

torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        world_size=world, rank=rank)

from repro_torch import configs
from repro_torch.launch import shardings
from repro_torch.models import moe, partitioning
from repro_torch.training import TrainConfig
from repro_torch.training.train import loss_and_grads
from repro_torch.tree import flatten_with_path, keystr

data = torch.load(tmp + "/case.pt")
out = {}


def group_bytes(mesh):
    return {axis: group.collective_bytes()
            for axis, group in mesh.groups.items()}


for name, case in data["cases"]:
    if case["kind"] == "launch":
        # the launcher builds its own mesh over the whole world
        from repro_torch.launch import train as launch_train
        history = []
        d, m = case["shape"]
        launch_train.run(case["arch"], True, 2, case["rows"], case["seq"], d,
                         m, 3e-3, case["micro"], None, device="cpu",
                         history=history)
        out[name] = [h["loss"] for h in history]
        continue
    mesh = partitioning.build_mesh(case["axes"], case["shape"])
    cfg = configs.get_reduced(case["arch"]).with_updates(**case["updates"])
    with partitioning.mesh_context(mesh):
        if case["kind"] == "block":
            rules = dict(partitioning.DEFAULT_RULES, fsdp=None)
            axes = moe.moe_axes(cfg)
            p = {key: shardings.local_shard(leaf, partitioning.resolve_spec(
                     mesh, axes[key], tuple(leaf.shape), rules), mesh)
                 for key, leaf in case["layer"].items()}
            lo, n = partitioning.batch_block(case["x"].shape[0])
            mesh.reset_bytes()
            y, aux = moe.moe_block(cfg, p, case["x"][lo:lo + n])
            out[name] = {"y": y, "rows": (lo, n), "bytes": group_bytes(mesh),
                         "aux": {k: float(v) for k, v in aux.items()},
                         "shapes": {k: tuple(v.shape) for k, v in p.items()}}
        elif case["kind"] == "train":
            tcfg = TrainConfig(aux_weight=case["aux_weight"])
            params = case["params"]
            specs = shardings.train_param_specs(mesh, cfg, params)
            p = shardings.local_shard(params, specs, mesh)
            n = case["rows"] // mesh.fsdp_size()
            lo = mesh.fsdp_index() * n
            batch = {k: v[lo:lo + n] for k, v in case["batch"].items()}
            loss, metrics, grads = loss_and_grads(cfg, tcfg, p, batch, specs)
            out[name] = {
                "loss": float(loss),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {keystr(path): shardings.gather_leaf(g, spec, mesh)
                          for (path, g), spec in zip(
                              flatten_with_path(grads),
                              partitioning.spec_leaves(specs, grads))}}
        elif case["kind"] == "micro":
            params = case["params"]
            specs = shardings.train_param_specs(mesh, cfg, params)
            n = case["rows"] // mesh.fsdp_size()
            lo = mesh.fsdp_index() * n
            batch = {k: v[lo:lo + n] for k, v in case["batch"].items()}
            loss, metrics, grads = loss_and_grads(
                cfg, TrainConfig(microbatches=2),
                shardings.local_shard(params, specs, mesh), batch, specs)
            out[name] = {
                "loss": float(loss),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {keystr(path): shardings.gather_leaf(g, spec, mesh)
                          for (path, g), spec in zip(
                              flatten_with_path(grads),
                              partitioning.spec_leaves(specs, grads))}}
        elif case["kind"] == "ckpt":
            from repro_torch.checkpoint import save
            specs = shardings.train_param_specs(mesh, cfg, case["params"])
            save(tmp + "/" + name, shardings.local_shard(
                case["params"], specs, mesh), shardings=specs)
            out[name] = tmp + "/" + name
        else:
            params = shardings.local_shard(
                case["params"], shardings.serving_param_specs(
                    mesh, cfg, case["params"]), mesh)
            mesh.reset_bytes()
            calls = serve_calls(cfg, case["coding"], params, case["inputs"],
                                case["wm"], case["pool"], case["max_len"])
            out[name] = {"calls": [(lg, loc) for lg, loc in calls],
                         "bytes": group_bytes(mesh)}
torch.save(out, tmp + "/rank" + str(rank) + ".pt")
dist.destroy_process_group()
'''


def _spawn(world, tmp):
    """Start ``world`` rank processes; returns a function that waits for
    them, fails the test if a rank fails or the run outlives TIMEOUT_S
    (every rank is killed), and returns each rank's outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

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
        failed = [f"rank {r} of {world}:\n{logs[r][-3000:]}"
                  for r, p in enumerate(procs) if p.returncode != 0]
        assert not failed, "\n".join(failed)
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return wait


# ------------------------------------------------------------ the inputs

def _skewed(jc, seed, rows, seq):
    """One MoE layer of the reference's seed-0 parameters with its router
    leaning to experts 0 and 1, and an input (rows, seq, d) whose shared
    direction carries that lean; with a padding row in ``PADDED``."""
    rng = np.random.RandomState(seed)
    d, e = jc.d_model, jc.num_experts
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    layer = {k: np.array(v[0]) for k, v in
             jp["blocks"]["runs"][0]["moe"].items()}
    u = rng.randn(d).astype(np.float32)
    u /= np.linalg.norm(u)
    lean = np.zeros(e, np.float32)
    lean[:2] = (1.5, 1.0)
    layer["router"] = (layer["router"] + np.outer(u, lean)).astype(
        np.float32)
    x = (rng.randn(rows, seq, d) + 2.0 * u).astype(np.float32)
    return layer, x


def _margin(jc, layer, x):
    """The smallest top-k margin of the reference's router logits."""
    logits = np.sort(x.reshape(-1, x.shape[-1]) @ layer["router"], -1)
    k = jc.experts_per_token
    return float((logits[:, -k] - logits[:, -k - 1]).min())


def _block_bytes(name, jc):
    """Per-rank bytes by group and op of one ``moe_block`` call: the
    top-k indices (tokens x k int64) all-gathered over the batch group
    ("fsdp") of F ranks, then over "worker" (W), and on a model axis of
    M that splits the leaves the (tokens, d) fp32 output all-reduced."""
    axes, shape, _, rows, seq, _ = BLOCKS[name]
    sizes = dict(zip(axes, shape))
    f = sizes.get("pod", 1) * sizes.get("data", 1)
    w, m = sizes.get("worker", 1), sizes.get("model", 1)
    local = rows * seq // (f * w)
    routes = local * jc.experts_per_token * 8
    want = {}
    if f > 1:
        want["fsdp"] = {"all-gather": (f - 1) * routes}
    if w > 1:
        want["worker"] = {"all-gather": (w - 1) * f * routes}
    if m > 1:
        want["model"] = {"all-reduce": 2 * (m - 1) / m * local
                         * jc.d_model * 4}
    return want


@pytest.fixture(scope="module")
def blocks():
    """Per block case: the reference's config, layer and input, and its
    ``moe_block`` on the whole input (y, aux)."""
    out = {}
    for name, (_, _, _, rows, seq, upd) in BLOCKS.items():
        jc = jconfigs.get_reduced(MOE).with_updates(**CF1, **upd)
        layer, x = _skewed(jc, 3 + len(out), rows, seq)
        if name in PADDED:
            x[-1] = x[0]
        jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(jc, p, x))(
            {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x))
        out[name] = (jc, layer, x, np.asarray(jy),
                     {k: float(v) for k, v in jaux.items()})
    return out


def _train_batch(cfg, seed):
    shape = ShapeConfig("t", SEQ + cfg.num_patches, ROWS, "train")
    return synthetic_batch(cfg, shape, np.random.RandomState(seed))


@pytest.fixture(scope="module")
def trains():
    """Per train case: the port's config, parameters (the reference's
    seed-0, converted), batch, its one-rank ``loss_and_grads`` and, for
    qwen3-moe, the reference's ``jax.grad`` of ``lm_loss``."""
    out = {}
    for name, (arch, _, aux_weight) in TRAINS.items():
        upd = CF1 if arch == MOE else {}
        jc = jconfigs.get_reduced(arch).with_updates(**upd)
        tc = tconfigs.get_reduced(arch).with_updates(**upd)
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        batch = _train_batch(tc, 5)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, metrics, grads = loss_and_grads(
            tc, TrainConfig(aux_weight=aux_weight), tp, tb)
        ref = None
        if arch == MOE:
            with jops.force_kernel("xla"):
                (jl, jm), jg = jax.jit(jax.value_and_grad(
                    lambda p, b: j_lm_loss(jc, p, b, aux_weight),
                    has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
            ref = (float(jl), {k: float(v) for k, v in jm.items()},
                   {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(jg)[0]})
        out[name] = (tc, tp, tb, (float(loss), {k: float(v) for k, v in
                                              metrics.items()},
                                  {keystr(p): g for p, g in
                                   flatten_with_path(grads)}), ref)
    return out


def _serve_inputs(cfg, coding_args, seed):
    """A serving run's prompt (modality dict), fixed next tokens, masks
    and (G, N+1, V) noise."""
    from repro_torch.core.berrut import CodingConfig
    k, s, e, g = coding_args
    n1 = CodingConfig(k=k, s=s, e=e).num_workers
    rng = np.random.RandomState(seed)
    mask = np.ones(n1, np.float32)
    mask[STRAGGLER % n1] = 0.0
    byz = np.zeros(n1, np.float32)
    byz[ATTACKER] = 1.0
    rows = g * k
    if cfg.modality == "audio":
        prompt = {"frames": rng.randn(rows, FRAMES, cfg.frontend_dim)}
        steps = np.zeros((0, rows, 1), np.int64)
    else:
        prompt = {"tokens": rng.randint(0, cfg.vocab_size,
                                        (rows, TEXT if cfg.modality == "vlm"
                                         else PLEN))}
        if cfg.modality == "vlm":
            prompt["patches"] = rng.randn(rows, cfg.num_patches,
                                          cfg.frontend_dim)
        steps = rng.randint(0, cfg.vocab_size, (STEPS, rows, 1))
    return {"prompt": {key: torch.from_numpy(
                np.asarray(v, np.float32) if v.dtype.kind == "f" else v)
                for key, v in prompt.items()},
            "steps": [torch.from_numpy(t) for t in steps],
            "mask": torch.from_numpy(mask), "byz": torch.from_numpy(byz),
            "noise": torch.from_numpy(rng.randn(
                g, n1, cfg.vocab_size).astype(np.float32))}


@pytest.fixture(scope="module")
def serves():
    """Per serving case: the port's config, parameters, inputs and its
    calls with no mesh."""
    out = {}
    for name, (arch, _, _, _, coding_args, wm, pool) in SERVES.items():
        tc = tconfigs.get_reduced(arch).with_updates(
            **(CF1 if arch == MOE else {}))
        tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        inp = _serve_inputs(tc, coding_args, 11 + len(out))
        max_len = FRONT_MAX_LEN if tc.modality == "vlm" else MAX_LEN
        out[name] = (tc, tp, inp, max_len,
                     serve_calls(tc, coding_args, tp, inp, wm, pool, max_len))
    return out


@pytest.fixture(scope="module")
def runs(blocks, trains, serves, tmp_path_factory):
    """{world: per-rank outputs} of the three gloo runs, started at
    once."""
    cases = {w: [] for w in (2, 3, 4)}
    for name, (axes, shape, world, _, _, upd) in BLOCKS.items():
        _, layer, x, _, _ = blocks[name]
        cases[world].append((name, {
            "kind": "block", "axes": axes, "shape": shape, "arch": MOE,
            "updates": dict(CF1, **upd), "x": torch.from_numpy(x),
            "layer": {k: torch.from_numpy(v) for k, v in layer.items()}}))
    for name, (arch, (d, m), aux_weight) in TRAINS.items():
        _, tp, tb, _, _ = trains[name]
        cases[d * m].append((name, {
            "kind": "train", "axes": ("data", "model"), "shape": (d, m),
            "arch": arch, "updates": CF1 if arch == MOE else {},
            "aux_weight": aux_weight, "params": tp, "batch": tb,
            "rows": ROWS}))
    for name, (arch, axes, shape, world, coding_args, wm, pool) in \
            SERVES.items():
        _, tp, inp, max_len, _ = serves[name]
        cases[world].append((name, {
            "kind": "serve", "axes": axes, "shape": shape, "arch": arch,
            "updates": CF1 if arch == MOE else {}, "params": tp,
            "inputs": inp, "coding": coding_args, "wm": wm, "pool": pool,
            "max_len": max_len}))
    for name, (arch, (d, m), micro) in LAUNCHES.items():
        cases[d * m].append((name, {"kind": "launch", "arch": arch,
                                    "shape": (d, m), "rows": ROWS,
                                    "seq": SEQ, "micro": micro}))
    _, tp, tb, _, _ = trains["t21"]
    cases[2].append(("micro", {
        "kind": "micro", "axes": ("data", "model"), "shape": (2, 1),
        "arch": MOE, "updates": CF1, "params": tp, "batch": tb,
        "rows": ROWS}))
    tc = tconfigs.get_reduced(MOE)
    cases[4].append(("ckpt_moe", {
        "kind": "ckpt", "axes": ("data", "model"), "shape": (2, 2),
        "arch": MOE, "updates": {},
        "params": tmodel.init_params(tc, torch.Generator().manual_seed(0),
                                     "cpu")}))
    waits = {}
    for world, todo in cases.items():
        tmp = tmp_path_factory.mktemp(f"moe{world}")
        torch.save({"cases": todo}, tmp / "case.pt")
        waits[world] = _spawn(world, tmp)
    return {world: wait() for world, wait in waits.items()}


# ------------------------------------------------------------ the fault

def test_worker_blocks_alone_differ_from_the_whole_batch(blocks):
    """The fault the routing gather repairs: each worker of (worker 3)
    running ``moe_block`` on its own 24 of the multihost decode step's
    72 streams (what a worker rank computed before the gather) groups,
    buffers and drops its tokens by its own count, so its rows differ
    from the reference's whole batch; so do its dropped fractions.  With
    the port's whole-batch routing on no mesh the rows are the
    reference's (the gloo run holds each worker's rows to them too)."""
    jc, layer, x, jy, jaux = blocks["w3"]
    tc = tconfigs.get_reduced(MOE).with_updates(**CF1)
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    assert tmoe.group_size(tc, 72) == 8 and tmoe.group_size(tc, 24) == 24
    assert tmoe._capacity(tc, 8) != tmoe._capacity(tc, 24)
    assert jaux["dropped_fraction"] > 0.1          # the capacity binds
    differ = 0
    for w in range(3):
        rows = slice(24 * w, 24 * (w + 1))
        y, aux = tmoe.moe_block(tc, tl, torch.from_numpy(x[rows]))
        assert torch.isfinite(y).all()
        differ += not np.allclose(y.numpy(), jy[rows], **OUT_TOL)
        assert aux["dropped_fraction"] != pytest.approx(
            jaux["dropped_fraction"])
    assert differ == 3
    whole, aux = tmoe.moe_block(tc, tl, torch.from_numpy(x))
    np.testing.assert_allclose(whole.numpy(), jy, **OUT_TOL)
    assert float(aux["dropped_fraction"]) == pytest.approx(
        jaux["dropped_fraction"])


# ------------------------------------------------------------ moe_block

@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_moe_block_rows_are_the_whole_batch(name, blocks, runs):
    """Each rank's rows of ``moe_block`` on its block (its experts, or
    its hidden units) are the reference's rows of the whole input; the
    aux shares sum over the batch groups to the reference's losses, the
    dropped fraction is the whole batch's on every rank; bytes by group
    and op as counted."""
    axes, shape, world, rows, seq, upd = BLOCKS[name]
    jc, layer, x, jy, jaux = blocks[name]
    assert _margin(jc, layer, x) > MARGIN
    assert jaux["dropped_fraction"] > 0.05          # the capacity binds
    ranks = [r[name] for r in runs[world]]
    sizes = dict(zip(axes, shape))
    split = sizes.get("worker", 1) * sizes.get("data", 1)
    lb = z = 0.0
    seen = set()
    for r, out in enumerate(ranks):
        lo, n = out["rows"]
        np.testing.assert_allclose(out["y"].numpy(), jy[lo:lo + n],
                                   **OUT_TOL, err_msg=f"{name} rank {r}")
        assert out["aux"]["dropped_fraction"] == pytest.approx(
            jaux["dropped_fraction"], abs=1e-6)
        if lo not in seen:                    # one share per batch block
            seen.add(lo)
            lb += out["aux"]["load_balance_loss"]
            z += out["aux"]["router_z_loss"]
        got = {g: {op: b for op, b in ops.items() if b and op != "total"}
               for g, ops in out["bytes"].items()}
        got = {g: ops for g, ops in got.items() if ops}
        want = _block_bytes(name, jc)
        assert set(got) == set(want), (name, r, got)
        for g, ops in want.items():
            assert got[g] == pytest.approx(ops), (name, r, g)
    assert len(seen) == split
    assert lb == pytest.approx(jaux["load_balance_loss"], rel=1e-5)
    assert z == pytest.approx(jaux["router_z_loss"], rel=1e-5)
    m = sizes.get("model", 1)
    e, f = jc.num_experts, jc.moe_d_ff
    want_shape = ((e // m, jc.d_model, f) if e % m == 0
                  else (e, jc.d_model, f // m))
    assert ranks[0]["shapes"]["w_gate"] == want_shape
    assert ranks[0]["shapes"]["router"] == (jc.d_model, e)


# ------------------------------------------------------------ training

@pytest.mark.parametrize("name", sorted(TRAINS))
def test_train_gradients_equal_one_rank_and_reference(name, trains, runs):
    """One ``loss_and_grads`` on the mesh: loss, metrics (the MoE
    statistics included) and every leaf's gradient equal one rank's,
    and for qwen3-moe the reference's ``jax.grad`` of ``lm_loss``; with
    the aux weight at 10 the router's gradient is mostly the aux losses',
    which the model axis must count once."""
    arch, (d, m), aux_weight = TRAINS[name]
    tc, _, _, (loss, metrics, grads), ref = trains[name]
    for r, rank in enumerate(runs[d * m]):
        out = rank[name]
        assert out["loss"] == pytest.approx(loss, rel=1e-5, abs=1e-6)
        for key, v in metrics.items():
            assert out["metrics"][key] == pytest.approx(
                v, rel=1e-5, abs=1e-6), (name, r, key)
        assert set(out["grads"]) == set(grads)
        for key, g in grads.items():
            tol = GRAD_TOL * max(float(g.abs().max()), 1e-30)
            err = float((out["grads"][key] - g).abs().max())
            assert err <= tol, (name, r, key, err, tol)
    if ref is None:
        return
    jl, jm, jg = ref
    assert loss == pytest.approx(jl, rel=1e-5)
    for key in ("ce_loss", "load_balance_loss", "dropped_fraction"):
        assert metrics[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-6)
    assert jm["dropped_fraction"] > 0.0             # the capacity binds
    for key, g in grads.items():
        want = jg[key]
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= tol, key
    router = [key for key in grads if key.endswith("['router']")]
    assert router
    if aux_weight > 1.0:
        # the aux term is most of the router's gradient: its share in
        # the reference's, against the same step at the usual weight
        _, _, (_, _, light), _ = trains["t12"][1:]
        for key in router:
            heavy = np.abs(jg[key]).max()
            assert heavy > 20 * float(light[key].abs().max())


def test_microbatches_of_a_split_moe_batch_refused(trains, runs):
    """No longer refused (ROADMAP A9.6): 2 microbatches of the batch
    split over (data 2), where the capacity binds, are the reference's
    rows i of the whole batch on every rank (``train._reference_micro_
    rows``), so their dispatch groups, drops and load-balance losses are
    one rank's microbatches': loss, metrics and every leaf's gradient
    equal the one-rank step's with the same microbatches."""
    tc, tp, tb, _, _ = trains["t21"]
    loss, metrics, grads = loss_and_grads(tc, TrainConfig(microbatches=2),
                                          tp, tb)
    assert float(metrics["dropped_fraction"]) > 0.0     # the capacity binds
    for r, rank in enumerate(runs[2]):
        out = rank["micro"]
        assert out["loss"] == pytest.approx(float(loss), rel=1e-5, abs=1e-6)
        for key, v in metrics.items():
            assert out["metrics"][key] == pytest.approx(
                float(v), rel=1e-5, abs=1e-6), (r, key)
        flat = {keystr(p): g for p, g in flatten_with_path(grads)}
        assert set(out["grads"]) == set(flat)
        for key, g in flat.items():
            tol = GRAD_TOL * max(float(g.abs().max()), 1e-30)
            err = float((out["grads"][key] - g).abs().max())
            assert err <= tol, (r, key, err, tol)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("name", sorted(SERVES))
def test_serving_on_the_mesh_equals_no_mesh(name, serves, runs):
    """The batch round (prefill and decode steps) or the slot pool on
    the mesh against the port with no mesh: decoded logits within
    ``LOGITS_TOL`` on every rank, verdicts equal."""
    arch, axes, shape, world, coding_args, wm, pool = SERVES[name]
    _, _, _, _, want = serves[name]
    for r, rank in enumerate(runs[world]):
        calls = rank[name]["calls"]
        assert len(calls) == len(want)
        for i, ((lg, loc), (wl, wloc)) in enumerate(zip(calls, want)):
            np.testing.assert_allclose(lg.numpy(), wl.numpy(), **LOGITS_TOL,
                                       err_msg=f"{name} rank {r} call {i}")
            assert torch.equal(loc, wloc), (name, r, i)
        if arch == MOE and dict(zip(axes, shape)).get("data", 1) > 1:
            assert rank[name]["bytes"]["fsdp"]["all-gather"] > 0


# ------------------------------------------------------------ layouts

def _layout(names, shape):
    """The reference's view of a mesh: what its partitioning reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


def _moe_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _moe_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _moe_leaves(v, path + (i,))
    elif "moe" in path:
        yield path, tree


@pytest.mark.parametrize("arch", [MOE, "grok-1-314b"])
@pytest.mark.parametrize("m", [2, 3, 16])
def test_moe_specs_equal_reference(arch, m, monkeypatch):
    """``serving_param_specs`` and ``train_param_specs`` of every MoE
    leaf at full width against the reference's ``resolve_spec`` (serving:
    the weights whole over the batch axes) and its launcher's
    ``tree_shardings``, on layout meshes (data 1 and 2, model ``m``):
    "experts" over "model" where the axis divides them (qwen3-moe's 128
    at 2 and 16), else "expert_ffn" where it divides the hidden units
    (grok's 8 experts of 32768 at 16), else whole (both at 3)."""
    monkeypatch.setattr(jshardings, "NamedSharding", lambda mesh, spec: spec)
    jc = jconfigs.get_config(arch)
    tc = tconfigs.get_config(arch)
    shapes = jax.tree.map(lambda s: types.SimpleNamespace(
        shape=tuple(s.shape)), j_abstract(jc))
    for d in (1, 2):
        names = ("data", "model")
        jmesh, tmesh = _layout(names, (d, m)), tpart.Mesh(names, (d, m))
        serve = tshardings.serving_param_specs(tmesh, tc, shapes)
        train = tshardings.train_param_specs(tmesh, tc, shapes)
        jtrain = jshardings.tree_shardings(jmesh, j_logical_axes(jc), shapes)
        rules = dict(jpart.DEFAULT_RULES, fsdp=None)
        axes = dict(_moe_leaves(j_logical_axes(jc)))
        seen = 0
        for path, leaf in _moe_leaves(shapes):
            got_s, got_t, want_t = serve, train, jtrain
            for key in path:
                got_s, got_t, want_t = got_s[key], got_t[key], want_t[key]
            want_s = jpart.resolve_spec(jmesh, axes[path], leaf.shape, rules)
            assert got_s == tuple(want_s), (path, got_s)
            assert got_t == tuple(want_t), (path, got_t)
            seen += 1
        assert seen == 4
        expert = serve["blocks"]["runs"][0]["moe"]["w_gate"]
        assert expert == ((None, "model", None, None)
                          if jc.num_experts % m == 0 else
                          (None, None, None, "model")
                          if jc.moe_d_ff % m == 0 else (None,) * 4)


def test_hubert_vocabulary_whole_on_a_16_way_axis(monkeypatch):
    """hubert-xlarge's 504 labels do not divide a 16-way model axis: its
    table stays whole there (``layers.unembed``'s whole-table branch),
    as the reference's ``resolve_spec`` keeps it; at 2 it splits."""
    jc = jconfigs.get_config("hubert-xlarge")
    tc = tconfigs.get_config("hubert-xlarge")
    shapes = jax.tree.map(lambda s: types.SimpleNamespace(
        shape=tuple(s.shape)), j_abstract(jc))
    for m, want in ((16, (None, None)), (2, ("model", None))):
        mesh = tpart.Mesh(("data", "model"), (1, m))
        specs = tshardings.serving_param_specs(mesh, tc, shapes)
        assert specs["embeddings"]["embed"] == want
        assert specs["embeddings"]["frontend_proj"] == (None, None)
        assert specs["embeddings"]["embed"] == tuple(jpart.resolve_spec(
            _layout(("data", "model"), (1, m)), ("vocab", "fsdp"),
            (504, jc.d_model), dict(jpart.DEFAULT_RULES, fsdp=None)))


# ------------------------------------------------------------ launchers

@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_trains_moe_on_the_mesh(name, runs):
    """``launch.train.run --data-par/--model-par`` trains reduced grok
    on a model axis (its 4 experts split) and reduced qwen3-moe on a
    split batch, with 1 or 2 microbatches, 2 steps: each rank's losses
    equal one process's run of the same command."""
    arch, (d, m), micro = LAUNCHES[name]
    from repro_torch.launch import train as tlaunch
    history = []
    tlaunch.run(arch, True, 2, ROWS, SEQ, 1, 1, 3e-3, micro, None,
                device="cpu", history=history)
    want = [h["loss"] for h in history]
    for rank in runs[d * m]:
        np.testing.assert_allclose(rank[name], want, rtol=1e-5)


def test_sharded_moe_checkpoint_reads_back_at_one_rank(runs):
    """A checkpoint written at (data 2, model 2) from the ranks' blocks
    (the experts split on dim 0 over "model", d_model on dim 1 over
    "data") reads back at one rank to the whole tree."""
    from repro_torch.checkpoint import load
    tc = tconfigs.get_reduced(MOE)
    like = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = load(runs[4][0]["ckpt_moe"], like)
    for (path, a), (_, b) in zip(flatten_with_path(got),
                                 flatten_with_path(like)):
        assert torch.equal(a, b), keystr(path)
