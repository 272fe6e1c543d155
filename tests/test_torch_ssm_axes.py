"""Port parity of Mamba2's "S" blocks on the model axis (ROADMAP A9.3b):
mamba2 and zamba2's backbone at a rank's block of the SSM heads.

The reference runs these blocks on any mesh under GSPMD, where its specs
only choose a layout; its spec of ``in_proj`` (``("fsdp", "ffn")`` over
[z | x | B | C | dt]) cuts contiguous blocks across those segments.  A
port rank holds a head-aligned block instead (``mamba2.ssm_block_layout``
beneath a ``partitioning.IndexSpec``): its heads' z, x and dt columns
with B and C whole, its heads' conv channels behind B and C's.  Three
cases of the layout: (i) the axis divides the heads and the spec splits
the leaf: the rank holds its block; (ii) the axis divides the heads but
the spec leaves the leaf whole (a width it does not divide): the rank
slices its heads at use; (iii) the axis does not divide the heads: every
rank runs the whole block on whole leaves, with no collective.

The gloo runs spawn one process per rank, as
``tests/test_torch_moe_axes.py`` does (a file store in the test's tmp
dir, one thread each, ``TIMEOUT_S`` a run), three runs at once: 2, 3
and 4 ranks.  Cases:
- ``mamba2_forward`` of one "S" layer of reduced mamba2-780m at model 2
  and 4 and of reduced zamba2-1.2b at model 2 (case i), of a variant of
  d_model 192 at model 3 (12 heads, 812 ``in_proj`` columns and 416 conv
  channels whole: case ii) and of reduced mamba2 at model 3 (16 heads:
  case iii): each rank's output against the reference's ``mamba2_block``
  on the whole input, its conv tail and final state against its block of
  the port's no-mesh ones, bytes against ``_block_bytes``;
- one ``loss_and_grads`` of reduced mamba2 at (data, model) = (1, 2) and
  (2, 2), of zamba2 at (1, 2) with the shared block at two "G" positions
  ("SGSG"), and of cases (ii) and (iii) at (1, 3): loss, gradient norm
  (``global_norm`` over the blocks) and every leaf's gradient against the
  one-rank port step and the reference's ``jax.grad`` of ``lm_loss``,
  bytes a step against ``_train_bytes``.  A B / C gradient counted twice,
  or the gated norm's counted once, misses ``GRAD_TOL``;
- serving: reduced mamba2's batch E=1 round and worker-major slot pool on
  (data 2, model 2), and reduced zamba2's batch round at model 2, against
  the port with no mesh: logits within ``LOGITS_TOL``, verdicts equal,
  each rank's caches its block of the no-mesh caches;
- a checkpoint saved from the blocks at (1, 2) is the one-rank file, and
  reads back on the mesh to each rank's blocks.
In this process: the specs of every S leaf and cache equal the
reference's, and ``local_shard`` then ``gather_leaf`` give back the whole
leaves of mamba2-780m at model 2, 3 and 16 and zamba2-1.2b at 2 and 3 at
full width (meta tensors for the shapes of the whole tree, values on one
layer).

Tolerances: outputs within rtol 1e-5, atol 1e-5 (fp32, the CPU); decoded
logits within ``LOGITS_TOL``; gradients within ``GRAD_TOL`` x each
leaf's max |grad| (``tests/test_torch_train_mesh.py``).
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
from repro.models import logical_axes as j_logical_axes  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models.model import lm_loss as j_lm_loss  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import shardings as tshardings  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import partitioning as tpart  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.training import TrainConfig  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
MAMBA, ZAMBA = "mamba2-780m", "zamba2-1.2b"
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = 1e-4
ROWS, SEQ = 4, 16
# case (ii): 12 heads a 3-way axis divides, 812 in_proj columns and 416
# conv channels it does not, din 384 it does
WIDE = {"d_model": 192}
SGSG = {"num_layers": 4, "layer_pattern": "SGSG"}
# name -> (arch, config updates, model axis): one S layer's forward
BLOCKS = {"m2": (MAMBA, {}, 2), "m4": (MAMBA, {}, 4), "z2": (ZAMBA, SGSG, 2),
          "wide3": (MAMBA, WIDE, 3), "whole3": (MAMBA, {}, 3)}
# name -> (arch, config updates, (data, model))
TRAINS = {"t12": (MAMBA, {}, (1, 2)), "t22": (MAMBA, {}, (2, 2)),
          "z12": (ZAMBA, SGSG, (1, 2)), "wide13": (MAMBA, WIDE, (1, 3)),
          "whole13": (MAMBA, {}, (1, 3))}
# name -> (arch, (data, model), pool)
SERVES = {"s_d2m2": (MAMBA, (2, 2), False),
          "s_d2m2_pool": (MAMBA, (2, 2), True),
          "s_z2": (ZAMBA, (1, 2), False)}
CODING = (2, 2, 1, 2)              # K, S, E, groups: 8 streams a group
PLEN, STEPS, MAX_LEN = 8, 2, 16
STRAGGLER, ATTACKER = 6, 1

# The serving calls, run on a mesh by the ranks and with no mesh here.
_CALLS = r'''
import numpy as np
import torch


def serve_calls(cfg, params, inp, pool):
    """Each call's (logits, located) of the batch round or of the
    worker-major slot pool with every slot admitted, and the caches after
    the last call, on the active mesh if any."""
    from repro_torch.core.berrut import CodingConfig
    from repro_torch.launch.worker_mesh import WorkerShardConfig
    from repro_torch.serving import coded_serving as cs
    k, s, e, g = inp["coding"]
    max_len = inp["max_len"]
    coding = CodingConfig(k=k, s=s, e=e)
    wshard = (WorkerShardConfig(gather_width=coding.num_workers) if pool
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
    else:
        state = cs.init_pool_state(cfg, coding, g, max_len, "cpu",
                                   wshard=wshard)
        fresh = cs.init_caches(cfg, cs.pool_streams(coding, g, wshard),
                               max_len, torch.float32, "cpu")
        live = np.ones((g,), np.float32)
        logits, state, rep = cs.coded_pool_prefill(
            cfg, coding, params, state, inp["prompt"], live, fresh, **kw)
        out.append((logits, rep[0]))
        for toks in inp["steps"]:
            logits, state, rep = cs.coded_pool_decode_step(
                cfg, coding, params, state, toks, live, **kw)
            out.append((logits, rep[0]))
    return out, [dict(c) for c in state.caches]
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
from repro_torch.models import mamba2, partitioning
from repro_torch.optim import global_norm
from repro_torch.training import TrainConfig
from repro_torch.training.train import loss_and_grads
from repro_torch.tree import flatten_with_path, keystr

data = torch.load(tmp + "/case.pt")
out = {}


def group_bytes(mesh):
    return {axis: group.collective_bytes()
            for axis, group in mesh.groups.items()}


for name, case in data["cases"]:
    mesh = partitioning.build_mesh(("data", "model"), case["shape"])
    cfg = configs.get_reduced(case["arch"]).with_updates(**case["updates"])
    with partitioning.mesh_context(mesh):
        if case["kind"] == "block":
            params = case["params"]
            local = shardings.local_shard(
                params, shardings.serving_param_specs(mesh, cfg, params),
                mesh)
            p = {k: v[0] for k, v in
                 local["blocks"]["runs"][0]["ssm"].items()}
            mesh.reset_bytes()
            y, tail, h = mamba2.mamba2_forward(cfg, p, case["x"])
            out[name] = {"y": y, "tail": tail, "h": h,
                         "bytes": group_bytes(mesh),
                         "shapes": {k: tuple(v.shape) for k, v in p.items()}}
        elif case["kind"] == "train":
            params = case["params"]
            specs = shardings.train_param_specs(mesh, cfg, params)
            p = shardings.local_shard(params, specs, mesh)
            n = case["rows"] // mesh.fsdp_size()
            lo = mesh.fsdp_index() * n
            batch = {k: v[lo:lo + n] for k, v in case["batch"].items()}
            mesh.reset_bytes()
            loss, metrics, grads = loss_and_grads(cfg, TrainConfig(), p,
                                                  batch, specs)
            step_bytes = mesh.axis_bytes()
            out[name] = {
                "loss": float(loss), "bytes": step_bytes,
                "norm": float(global_norm(grads, specs)),
                "grads": {keystr(path): shardings.gather_leaf(g, spec, mesh)
                          for (path, g), spec in zip(
                              flatten_with_path(grads),
                              partitioning.spec_leaves(specs, grads))}}
        elif case["kind"] == "ckpt":
            from repro_torch.checkpoint import load, save
            params = case["params"]
            specs = shardings.train_param_specs(mesh, cfg, params)
            local = shardings.local_shard(params, specs, mesh)
            save(tmp + "/" + name, local, shardings=specs)
            back = load(tmp + "/" + name, params, shardings=specs)
            out[name] = {"path": tmp + "/" + name, "back_equal": all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    flatten_with_path(back), flatten_with_path(local)))}
        else:
            params = shardings.local_shard(
                case["params"], shardings.serving_param_specs(
                    mesh, cfg, case["params"]), mesh)
            calls, caches = serve_calls(cfg, params, case["inputs"],
                                        case["pool"])
            out[name] = {"calls": calls, "caches": caches}
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


# ------------------------------------------------------------ the layout

def _heads(cfg, m, r):
    """Rank r's head-aligned columns of in_proj and channels of the conv
    on an m-way axis, written out from the segments [z | x | B | C | dt]
    (independently of ``mamba2.ssm_block_layout``)."""
    din, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    dr, hr = din // m, h // m
    inner = np.arange(r * dr, (r + 1) * dr)
    bc = 2 * din + np.arange(2 * n)
    proj = np.concatenate([inner, din + inner, bc,
                           2 * din + 2 * n + np.arange(r * hr, (r + 1) * hr)])
    conv = np.concatenate([inner, din + np.arange(2 * n)])
    return proj, conv, np.arange(r * hr, (r + 1) * hr)


def _block_bytes(cfg, m, rows, seq):
    """Per-rank "model" bytes of one S layer's forward on an m-way axis
    that divides the heads: the (rows, seq, d) fp32 ``out_proj`` partial
    and the gated norm's (rows, seq) sums of squares all-reduced (ring:
    2 B (m-1)/m); none where the axis does not divide the heads."""
    if m == 1 or cfg.ssm_heads % m:
        return {}
    return {"model": {"all-reduce": 2 * (m - 1) / m * rows * seq
                      * (cfg.d_model + 1) * 4}}


def _train_bytes(cfg, d, m, rows, seq):
    """Per-rank bytes of one fp32 ``loss_and_grads`` of a model of "S"
    layers and shared "G" positions (no remat) on (data d, model m), the
    axis dividing the kv-heads.  "model": where the axis divides the
    vocabulary, the embedding's all-reduce and x into the vocabulary's
    product (2 x (tokens, d)) and the logits' all-gather; a "G"
    position's attention and MLP outputs and x into each (4 x (tokens,
    d)); where it divides the SSM heads, an S layer's out_proj partial
    and x into its heads (2 x (tokens, d)), its sums of squares both ways
    (2 x (tokens,)), B and C (tokens, 2N), its three (H,) per-head
    vectors, and the gradient of each leaf the spec leaves whole that the
    rank slices (case ii: in_proj, the conv).  "fsdp" (d > 1): every
    leaf's model-local whole gathered and its gradient reduce-scattered,
    or all-reduced where the batch axes leave it whole, and the loss with
    4 metrics."""
    p = cfg.layer_pattern
    s, g = p.count("S"), p.count("G")
    dm, n, h, v = cfg.d_model, cfg.ssm_state, cfg.ssm_heads, cfg.vocab_size
    din, k = cfg.ssm_d_inner, cfg.ssm_conv
    tokens = rows // d * seq
    out = {}
    if m > 1:
        vocab = v % m == 0
        ar = tokens * dm * (2 * vocab + 4 * g)
        if h % m == 0:
            width, conv = 2 * din + 2 * n + h, din + 2 * n
            ar += s * (2 * tokens * dm + tokens * 2 * n + 2 * tokens + 3 * h
                       + (dm * width if width % m else 0)
                       + ((k + 1) * conv if conv % m else 0))
        out["model"] = 2 * (m - 1) / m * ar * 4 \
            + vocab * (m - 1) / m * tokens * v * 4
        if not out["model"]:
            del out["model"]
    if d > 1:
        hd, hq, kv, ff = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, \
            cfg.d_ff
        shared = (2 * dm * hq * hd + 2 * dm * kv * hd + 3 * dm * ff) / m \
            + 2 * dm if g else 0
        leaves = v * dm * (1 if cfg.tie_embeddings else 2) / m + dm + s * (
            dm * (2 * din / m + 2 * n + h / m) + din / m * dm + dm
            + k * (din / m + 2 * n) + (din / m + 2 * n) + 3 * h + din / m) \
            + shared
        out["fsdp"] = 2 * (d - 1) / d * (leaves + 5) * 4
    return out


# ------------------------------------------------------------ the inputs

def _configs(arch, upd):
    return (jconfigs.get_reduced(arch).with_updates(**upd),
            tconfigs.get_reduced(arch).with_updates(**upd))


_PARAMS: dict = {}


def _params(jc, tc):
    """The port's seed-0 parameters of ``tc`` and the same values as the
    reference's tree (one draw a config)."""
    if jc not in _PARAMS:
        tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        _PARAMS[jc] = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp),
                       tp)
    return _PARAMS[jc]


def _block_input(name):
    """A block case's configs, parameters and (2, 12, d) input."""
    arch, upd, _ = BLOCKS[name]
    jc, tc = _configs(arch, upd)
    jp, tp = _params(jc, tc)
    x = np.random.RandomState(3 + sorted(BLOCKS).index(name)).randn(
        2, 12, jc.d_model).astype(np.float32)
    return jc, tc, jp, tp, x


def _train_input(name):
    """A train case's configs, parameters and batch (numpy and torch)."""
    arch, upd, _ = TRAINS[name]
    jc, tc = _configs(arch, upd)
    jp, tp = _params(jc, tc)
    batch = synthetic_batch(tc, ShapeConfig("t", SEQ, ROWS, "train"),
                            np.random.RandomState(5))
    return jc, tc, jp, tp, batch, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}


def _serve_input(name):
    """A serving case's config, parameters and inputs."""
    from repro_torch.core.berrut import CodingConfig
    arch = SERVES[name][0]
    jc, tc = _configs(arch, {})
    _, tp = _params(jc, tc)
    k, s, e, g = CODING
    n1 = CodingConfig(k=k, s=s, e=e).num_workers
    rng = np.random.RandomState(11 + sorted(SERVES).index(name))
    mask = np.ones(n1, np.float32)
    mask[STRAGGLER % n1] = 0.0
    byz = np.zeros(n1, np.float32)
    byz[ATTACKER] = 1.0
    return tc, tp, {
        "coding": CODING, "max_len": MAX_LEN,
        "prompt": {"tokens": torch.from_numpy(
            rng.randint(0, tc.vocab_size, (g * k, PLEN)))},
        "steps": [torch.from_numpy(t) for t in
                  rng.randint(0, tc.vocab_size, (STEPS, g * k, 1))],
        "mask": torch.from_numpy(mask), "byz": torch.from_numpy(byz),
        "noise": torch.from_numpy(rng.randn(
            g, n1, tc.vocab_size).astype(np.float32))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The three gloo runs (2, 3 and 4 ranks), started at once before the
    references are computed here: {world: a function that waits for the
    run and returns its per-rank outputs}."""
    cases = {w: [] for w in (2, 3, 4)}
    for name, (arch, upd, m) in BLOCKS.items():
        _, _, _, tp, x = _block_input(name)
        cases[m].append((name, {"kind": "block", "shape": (1, m),
                                "arch": arch, "updates": upd, "params": tp,
                                "x": torch.from_numpy(x)}))
    for name, (arch, upd, (d, m)) in TRAINS.items():
        *_, tp, _, tb = _train_input(name)
        cases[d * m].append((name, {
            "kind": "train", "shape": (d, m), "arch": arch, "updates": upd,
            "params": tp, "batch": tb, "rows": ROWS}))
    for name, (arch, (d, m), pool) in SERVES.items():
        _, tp, inp = _serve_input(name)
        cases[d * m].append((name, {
            "kind": "serve", "shape": (d, m), "arch": arch, "updates": {},
            "params": tp, "inputs": inp, "pool": pool}))
    *_, tp, _, _ = _train_input("t12")
    cases[2].append(("ckpt", {"kind": "ckpt", "shape": (1, 2),
                              "arch": MAMBA, "updates": {}, "params": tp}))
    waits = {}
    for world, todo in cases.items():
        tmp = tmp_path_factory.mktemp(f"ssm{world}")
        torch.save({"cases": todo}, tmp / "case.pt")
        waits[world] = _spawn(world, tmp)
    return waits


@pytest.fixture(scope="module")
def blocks(spawned):
    """Per block case: the port's config, the input, the reference's
    ``mamba2_block`` of the first S layer on the whole input, and the
    port's no-mesh conv tail and final state."""
    out, jitted = {}, {}
    for name in BLOCKS:
        jc, tc, jp, tp, x = _block_input(name)
        layer = jax.tree.map(lambda t: t[0], jp["blocks"]["runs"][0]["ssm"])
        if jc not in jitted:
            jitted[jc] = jax.jit(lambda p, x, jc=jc: jmamba2.mamba2_block(
                jc, p, x))
        with jops.force_kernel("xla"):
            jy = jitted[jc](layer, jnp.asarray(x))
        p0 = {k: v[0] for k, v in tp["blocks"]["runs"][0]["ssm"].items()}
        _, tail, h = tmamba2.mamba2_forward(tc, p0, torch.from_numpy(x))
        out[name] = (tc, x, np.asarray(jy), tail, h)
    return out


@pytest.fixture(scope="module")
def trains(spawned):
    """Per train case: the port's config, its one-rank ``loss_and_grads``
    (loss, gradient norm, gradients) and the reference's ``jax.grad`` of
    ``lm_loss`` (one step a config: the same batch)."""
    out, done = {}, {}
    for name in TRAINS:
        jc, tc, jp, tp, batch, tb = _train_input(name)
        if jc not in done:
            loss, _, grads = loss_and_grads(tc, TrainConfig(), tp, tb)
            with jops.force_kernel("xla"):
                (jl, _), jg = jax.jit(jax.value_and_grad(
                    lambda p, b: j_lm_loss(jc, p, b), has_aux=True))(
                        jp, jax.tree.map(jnp.asarray, batch))
            done[jc] = (
                (float(loss), float(global_norm(grads)),
                 {keystr(p): g for p, g in flatten_with_path(grads)}),
                (float(jl), {jax.tree_util.keystr(p): np.asarray(v) for p, v
                             in jax.tree_util.tree_flatten_with_path(jg)[0]}))
        out[name] = (tc, tp) + done[jc]
    return out


@pytest.fixture(scope="module")
def serves(spawned):
    """Per serving case: the port's config and its calls and caches with
    no mesh."""
    out = {}
    for name, (_, _, pool) in SERVES.items():
        tc, tp, inp = _serve_input(name)
        out[name] = (tc, serve_calls(tc, tp, inp, pool))
    return out


@pytest.fixture(scope="module")
def runs(spawned, blocks, trains, serves):
    """{world: per-rank outputs} of the three gloo runs."""
    return {world: wait() for world, wait in spawned.items()}


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_at_a_ranks_heads_equals_reference(name, blocks, runs):
    """Each rank's ``mamba2_forward`` of one S layer is the reference's
    ``mamba2_block`` on the whole input; its conv tail is its channels [x_r
    | B | C] and its final state its heads of the no-mesh ones (whole in
    case iii); the leaves it holds are its head-aligned blocks (case i),
    whole where the spec leaves them so (case ii: in_proj and the conv
    whole, gate_norm and out_proj split) or where the axis does not
    divide the heads (case iii); bytes as counted."""
    arch, upd, m = BLOCKS[name]
    tc, x, jy, tail, h = blocks[name]
    din, n, d = tc.ssm_d_inner, tc.ssm_state, tc.d_model
    whole = tc.ssm_heads % m != 0
    width = 2 * din + 2 * n + tc.ssm_heads
    split = not whole and width % m == 0
    for r, rank in enumerate(runs[m]):
        out = rank[name]
        np.testing.assert_allclose(out["y"].numpy(), jy, **OUT_TOL,
                                   err_msg=f"{name} rank {r}")
        if whole:
            want_tail, want_h = tail, h
        else:
            _, conv, heads = _heads(tc, m, r)
            want_tail, want_h = tail[..., conv], h[:, heads]
        np.testing.assert_allclose(out["tail"].numpy(), want_tail.numpy(),
                                   **OUT_TOL)
        np.testing.assert_allclose(out["h"].numpy(), want_h.numpy(),
                                   **OUT_TOL)
        got = {g: {op: b for op, b in ops.items() if b and op != "total"}
               for g, ops in out["bytes"].items()}
        got = {g: ops for g, ops in got.items() if ops}
        want = _block_bytes(tc, m, *x.shape[:2])
        assert set(got) == set(want), (name, r, got)
        for g, ops in want.items():
            assert got[g] == pytest.approx(ops), (name, r, g)
        shapes = out["shapes"]
        dr = din if whole else din // m
        assert shapes["in_proj"] == (
            (d, 2 * dr + 2 * n + tc.ssm_heads // m) if split else (d, width))
        assert shapes["gate_norm"] == (dr,)
        assert shapes["out_proj"] == (dr, d)
        assert shapes["a_log"] == (tc.ssm_heads,)
    assert name != "wide3" or (not whole and not split
                               and tc.ssm_d_inner % m == 0)
    assert name != "whole3" or whole


# ------------------------------------------------------------ training

@pytest.mark.parametrize("name", sorted(TRAINS))
def test_train_gradients_equal_one_rank_and_reference(name, trains, runs):
    """One ``loss_and_grads`` on the mesh: the loss, the gradient norm of
    the blocks (``global_norm``: B and C's columns counted once) and every
    leaf's gradient, gathered to the reference's layout, equal one
    rank's and the reference's ``jax.grad`` of ``lm_loss``; bytes by
    group as counted."""
    arch, upd, (d, m) = TRAINS[name]
    tc, _, (loss, norm, grads), (jl, jg) = trains[name]
    assert loss == pytest.approx(jl, rel=1e-5)
    for key, g in grads.items():
        want = jg[key]
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= tol, key
    for r, rank in enumerate(runs[d * m]):
        out = rank[name]
        assert out["loss"] == pytest.approx(loss, rel=1e-5, abs=1e-6)
        assert out["norm"] == pytest.approx(norm, rel=1e-5)
        assert set(out["grads"]) == set(grads)
        for key, g in grads.items():
            tol = GRAD_TOL * max(float(g.abs().max()), 1e-30)
            err = float((out["grads"][key] - g).abs().max())
            assert err <= tol, (name, r, key, err, tol)
        want = _train_bytes(tc, d, m, ROWS, SEQ)
        got = {k: v for k, v in out["bytes"].items() if v}
        assert set(got) == set(want), (name, r, got)
        for k, v in want.items():
            assert got[k] == pytest.approx(v), (name, r, k)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("name", sorted(SERVES))
def test_serving_on_the_mesh_equals_no_mesh(name, serves, runs):
    """The batch round or the slot pool on the mesh against the port with
    no mesh: decoded logits within ``LOGITS_TOL`` on every rank, verdicts
    equal, each rank's caches its block of the no-mesh caches under
    ``cache_shardings`` (its streams, SSM heads and conv channels, and
    zamba2's kv-heads)."""
    arch, (d, m), _ = SERVES[name]
    tc, (want, caches) = serves[name]
    for r, rank in enumerate(runs[d * m]):
        calls = rank[name]["calls"]
        assert len(calls) == len(want)
        for i, ((lg, loc), (wl, wloc)) in enumerate(zip(calls, want)):
            np.testing.assert_allclose(lg.numpy(), wl.numpy(), **LOGITS_TOL,
                                       err_msg=f"{name} rank {r} call {i}")
            assert torch.equal(loc, wloc), (name, r, i)
        mesh = tpart.Mesh(("data", "model"), (d, m), r)
        block = tshardings.local_shard(
            caches, tshardings.cache_shardings(mesh, tc, caches), mesh)
        for i, (got, mine) in enumerate(zip(rank[name]["caches"], block)):
            for key, leaf in mine.items():
                np.testing.assert_allclose(
                    got[key].numpy(), leaf.numpy(), **LOGITS_TOL,
                    err_msg=f"{name} rank {r} run {i} {key}")
        conv = rank[name]["caches"][0]["conv"]
        assert conv.shape[-1] == tc.ssm_d_inner // m + 2 * tc.ssm_state


# ------------------------------------------------------------ checkpoints

def test_sharded_mamba2_checkpoint_is_the_one_rank_file(runs, trains,
                                                        tmp_path):
    """A checkpoint saved at (1, 2) from the ranks' head-aligned blocks is
    the one-rank file (B and C once, the reference's column order), and
    reads back on the mesh to each rank's blocks."""
    from repro_torch.checkpoint import save
    _, tp, _, _ = trains["t12"]
    save(str(tmp_path / "one"), tp)
    with np.load(str(tmp_path / "one.npz")) as one, \
            np.load(runs[2][0]["ckpt"]["path"] + ".npz") as meshed:
        assert sorted(one.files) == sorted(meshed.files)
        for key in one.files:
            np.testing.assert_array_equal(meshed[key], one[key], err_msg=key)
    assert all(rank["ckpt"]["back_equal"] for rank in runs[2])


# ------------------------------------------------------------ layouts

def _layout(names, shape):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


def _s_leaves(specs, runs_of):
    """(run, leaf name, spec) of every S run's leaf."""
    for i, run in enumerate(runs_of(specs)):
        if isinstance(run, dict) and "ssm" in run:
            for k, v in run["ssm"].items():
                yield i, k, v


class _Gather:
    """The model group of a layout mesh over the blocks every rank of the
    axis holds, computed in this process: its all-gather joins them."""

    def __init__(self, blocks):
        self.blocks = blocks

    def all_gather(self, x, dim):
        return torch.cat(self.blocks, dim)


def _round_trip(leaf, spec, meshes):
    """Each rank's ``local_shard`` of ``leaf``, and what ``gather_leaf``
    gives back from each rank's block over them (a ``_Gather`` group)."""
    blocks = [tshardings.local_shard(leaf, spec, mesh) for mesh in meshes]
    back = []
    for mesh, block in zip(meshes, blocks):
        mesh.groups = {"model": _Gather(blocks)}
        back.append(tshardings.gather_leaf(block, spec, mesh))
    return blocks, back


@pytest.mark.parametrize("arch, m", [(MAMBA, 2), (MAMBA, 3), (MAMBA, 16),
                                     (ZAMBA, 2), (ZAMBA, 3)])
def test_local_shard_and_gather_round_trip_full_width(arch, m, monkeypatch):
    """At full width on a (data 1, model m) layout mesh: the training
    specs and the cache specs of every S leaf equal the reference's; every
    rank's ``local_shard`` of each S leaf of the whole tree (meta tensors)
    has the head-aligned shape, or the whole one where the axis does not
    divide the heads (zamba2's conv_w whole at 3 though the spec splits
    its 4224 channels) or the spec leaves it whole (mamba2's in_proj at
    3), and ``gather_leaf`` of the ranks' blocks has the whole shape; on
    one layer's values rank 1's in_proj block is [z_1 | x_1 | B | C |
    dt_1] and its conv block [x_1 | B | C], and ``gather_leaf`` gives back
    the whole leaf on every rank.  (d_model over "data" too: the (2, 2)
    training case of the gloo runs gathers its gradients so.)"""
    monkeypatch.setattr(jshardings, "NamedSharding", lambda mesh, spec: spec)
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    names, shape = ("data", "model"), (1, m)
    jmesh = _layout(names, shape)
    shapes = jax.tree.map(lambda s: torch.empty(tuple(s.shape),
                                                device="meta"),
                          j_abstract(jc))
    want = jshardings.tree_shardings(jmesh, j_logical_axes(jc), shapes)
    meshes = [tpart.Mesh(names, shape, r) for r in range(m)]
    got = tshardings.train_param_specs(meshes[0], tc, shapes)
    runs_of = (lambda t: t["blocks"]["runs"])
    ref = {(i, k): tuple(v) for i, k, v in _s_leaves(want, runs_of)}
    mine = {(i, k): v for i, k, v in _s_leaves(got, runs_of)}
    assert mine and sorted(mine) == sorted(ref)
    for key, spec in mine.items():
        assert spec == ref[key], key
    cut = tc.with_updates(num_layers=2, layer_pattern="SS")
    caches = tmodel.init_caches(cut, 4, 8, torch.float32, "meta")
    cache_want = jshardings.cache_shardings(
        jmesh, jc.with_updates(num_layers=2, layer_pattern="SS"),
        jax.tree.map(lambda t: types.SimpleNamespace(shape=tuple(t.shape)),
                     caches))
    cache_got = tshardings.cache_shardings(meshes[0], cut, caches)
    assert [tuple(v) for c in cache_got for v in c.values()] == [
        tuple(v) for c in cache_want for v in c.values()]
    whole = tc.ssm_heads % m != 0
    din, n, d, h = tc.ssm_d_inner, tc.ssm_state, tc.d_model, tc.ssm_heads
    width = {"in_proj": 2 * din + 2 * n + h, "conv_w": din + 2 * n,
             "conv_b": din + 2 * n, "gate_norm": din, "out_proj": din}
    local = {"in_proj": 2 * din // m + 2 * n + h // m,
             "conv_w": din // m + 2 * n, "conv_b": din // m + 2 * n,
             "gate_norm": din // m, "out_proj": din // m}
    dims = {"in_proj": 2, "conv_w": 2, "conv_b": 1, "gate_norm": 1,
            "out_proj": 1}
    s_run = next(run for run in runs_of(got) if run and "ssm" in run)["ssm"]
    leaves = next(run for run in shapes["blocks"]["runs"]
                  if run and "ssm" in run)["ssm"]
    for k, leaf in leaves.items():
        blocks, back = _round_trip(leaf, s_run[k], meshes)
        assert all(b.shape == leaf.shape for b in back), k
        if k not in dims:
            continue
        split = not whole and s_run[k][dims[k]] is not None
        assert all(b.shape[dims[k]] == (local[k] if split else width[k])
                   for b in blocks), (k, blocks[0].shape)
    # one layer's values through every rank and back
    for k, leaf in leaves.items():
        v = torch.arange(leaf[:1].numel(), dtype=torch.float32).reshape(
            leaf[:1].shape)
        blocks, back = _round_trip(v, s_run[k], meshes)
        for r, b in enumerate(back):
            assert torch.equal(b, v), (arch, m, k, r)
        if k in ("in_proj", "conv_w") and not whole and \
                s_run[k][dims[k]] is not None:
            proj, conv, _ = _heads(tc, m, 1)
            np.testing.assert_array_equal(
                blocks[1].numpy(),
                v[..., proj if k == "in_proj" else conv].numpy())
