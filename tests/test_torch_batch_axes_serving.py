"""Port parity of serving on the batch axes "pod" and "data" (ROADMAP
A9.5), and the MoE layer on a split serving batch.

A rank's block of the flat coded-stream axis is its coordinates read in
the reference's "batch" rule order ("worker", "pod", "data"), worker
outermost (``partitioning.batch_block``), held here against the
reference's ``resolve_spec`` on layout meshes (an object with
``axis_names`` and ``devices.shape``, as in
``tests/test_torch_mesh_serving.py``).

The MoE layer's dispatch groups and their capacity follow the token
count of the rows it runs, so a rank's block of a split batch run alone
keeps or drops other tokens than the whole batch does: shown on reduced
qwen3-moe-30b-a3b with its router zeroed (every token picks the same
two experts) and a capacity factor of 1.  On a mesh with its groups the
layer gathers the whole batch's routes instead
(``tests/test_torch_moe_axes.py``), and every serving step takes it on
a pod or data axis above 1.

The gloo runs spawn one process per rank, as
``tests/test_torch_mesh_serving.py`` does (a file store in the test's tmp
dir, one thread each, ``TIMEOUT_S`` a run), on three meshes at once:
(pod 2), (data 2) and (pod 2, worker 2).  Each rank serves reduced
qwen3-0.6b from the reference's converted weights at K=2 S=2 E=1 over 2
groups, one straggler and a sigma-10 attacker: the batch round
(``coded_prefill`` and two ``coded_decode_step``s on fixed next tokens;
group-major off the worker axis, and worker-major on every mesh), the
slot pool and the worker-major pool (a prefill of slot 0, a decode
round, slot 1 admitted mid-flight, a decode round of both).  Each run is
held against the reference's single-device steps (the group-major batch
round and pool) and against the port's one-rank path of its own layout:
logits within ``LOGITS_TOL``, greedy tokens equal except at near ties,
verdicts equal or explained by their exact tally
(``_torch_parity.near_tie_walk``), each rank's caches equal to its
block of the one-rank caches, and the collective bytes by op and group
equal to the analytic count.  On (data 2) the group-major pool also runs
padded (K=2 S=1 E=1 over 3 slots: 21 streams, 22 on two ranks) for
reduced qwen3 and for reduced mamba2-780m (the conv window and SSM
state), held against the port's one-rank path: the padding stream is
never written into a live slot.
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
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import partitioning as jpart  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch.worker_mesh import WorkerShardConfig  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import partitioning as tpart  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

from _torch_parity import capture_columns, near_tie_walk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240
ARCH = "qwen3-0.6b"
K, S, E, G = 2, 2, 1, 2            # 8 coded streams a group, 16 in all
PAD = (2, 1, 1, 3)                 # 7 streams x 3 slots: 21, 22 on 2 ranks
PLEN, STEPS = 8, 2
MAX_LEN = PLEN + STEPS + 4
STRAGGLER, ATTACKER = 6, 1
# name -> (axes, shape): the meshes of the gloo runs
MESHES = {"pod2": (("pod", "worker", "model"), (2, 1, 1)),
          "data2": (("data", "model"), (2, 1)),
          "pod2_worker2": (("pod", "worker", "model"), (2, 2, 1))}
LAYOUTS = [(("pod", "worker", "model"), (2, 2, 2)),
           (("pod", "worker", "model"), (2, 4, 1)),
           (("worker", "data", "model"), (2, 2, 2)),
           (("worker", "data", "model"), (4, 2, 1)),
           (("data", "model"), (2, 4))]


def _layout(names, shape):
    """The reference's view of a mesh: what its partitioning reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


def _pool_calls(slots):
    """The pool's calls: every slot but slot 1 prefilled, a decode round,
    slot 1 admitted mid-flight, a decode round of every slot."""
    first = np.ones(slots, np.float32)
    first[1] = 0.0
    late = np.zeros(slots, np.float32)
    late[1] = 1.0
    return [("prefill", first), ("decode", first), ("prefill", late),
            ("decode", np.ones(slots, np.float32))]


def _runs(name):
    """The runs of a mesh: (run, arch, (K, S, E, groups), worker-major,
    pool)."""
    workers = dict(zip(*MESHES[name])).get("worker", 1)
    out = [("batch_wm", ARCH, (K, S, E, G), True, False),
           ("pool_wm", ARCH, (K, S, E, G), True, True)]
    if workers == 1:
        out += [("batch", ARCH, (K, S, E, G), False, False),
                ("pool", ARCH, (K, S, E, G), False, True)]
    if name == "data2":
        out += [("pad", ARCH, PAD, False, True),
                ("pad_mamba2", "mamba2-780m", PAD, False, True)]
    return out


# ------------------------------------------------------------ the block rule

@pytest.mark.parametrize("names, shape", LAYOUTS)
def test_batch_block_is_the_reference_batch_spec(names, shape):
    """Every rank's ``batch_block`` is the block that the reference's
    ``PartitionSpec`` of ("batch",) puts on it: its coordinates over the
    spec's axes read row-major."""
    n = 4 * int(np.prod(shape))
    spec = jpart.resolve_spec(_layout(names, shape), ("batch",), (n,))[0]
    axes = (spec,) if isinstance(spec, str) else tuple(spec or ())
    assert tpart.resolve_spec(tpart.Mesh(names, shape), ("batch",),
                              (n,)) == (spec,)
    sizes = dict(zip(names, shape))
    blocks = int(np.prod([sizes[a] for a in axes]))
    seen = set()
    for rank in range(int(np.prod(shape))):
        mesh = tpart.Mesh(names, shape, rank)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.coord(a)
        start, length = tpart.batch_block(n, mesh)
        assert (start, length) == (idx * n // blocks, n // blocks)
        # the batch group (pod and data jointly) is in block order
        assert mesh.fsdp_index() == mesh.coord("pod") * mesh.size("data") \
            + mesh.coord("data")
        seen.add(start)
    assert len(seen) == blocks
    with pytest.raises(ValueError, match="do not split"):
        tpart.batch_block(n + 1, tpart.Mesh(names, shape))
    assert tpart.batch_block(7) == (0, 7)              # off any mesh


# ------------------------------------------------------------ the MoE layer

def _moe_config():
    """Reduced qwen3-moe, capacity factor 1, router zeroed: every token
    picks experts 0 and 1 (the ties go to the lower index), so an
    expert's buffer fills and drops tokens."""
    return tconfigs.get_reduced("qwen3-moe-30b-a3b").with_updates(
        capacity_factor=1.0)


def test_moe_block_differs_from_the_whole_batch():
    """The fault that the MoE layer's routing gather repairs: a rank's
    block of a padded batch (5 streams padded to 6 on data 2, its 3
    streams) run alone (a layout mesh has no groups to gather over)
    keeps other tokens in the experts' buffers than the whole batch
    does, so its rows of the prefill and of a decode step differ from
    the whole batch's."""
    cfg = _moe_config()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for run in params["blocks"]["runs"]:
        run["moe"]["router"].zero_()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, PLEN, cfg.d_model).astype(np.float32))
    tok = torch.from_numpy(rng.randn(6, 1, cfg.d_model).astype(np.float32))
    rows = slice(3, 6)                                # rank 1's block

    def run(x, tok):
        caches = tmodel.init_caches(cfg, x.shape[0], MAX_LEN, torch.float32,
                                    "cpu")
        first, caches = tmodel.prefill(cfg, params, {"embeddings": x},
                                       caches)
        step, _ = tmodel.decode_step(cfg, params, caches,
                                     {"embeddings": tok}, PLEN)
        return first, step

    whole = run(x, tok)
    mesh = tpart.Mesh(("data", "model"), (2, 1), rank=1)
    with tpart.mesh_context(mesh):
        assert tpart.batch_block(6) == (3, 3)
        block = run(x[rows], tok[rows])
    for w, b in zip(whole, block):
        assert torch.isfinite(b).all()
        assert not torch.allclose(b, w[rows], **LOGITS_TOL)


@pytest.mark.parametrize("names, shape", [(("data", "model"), (2, 1)),
                                          (("pod", "worker", "model"),
                                           (2, 1, 1))])
def test_moe_refused_on_a_split_serving_batch(names, shape):
    """No serving step refuses the MoE layer on a pod or data axis any
    more: the pool takes the rank's block of the streams, padded as for
    a dense model; the one error left is a worker axis without
    ``wshard``."""
    cfg = _moe_config()
    coding = TCoding(k=K, s=S, e=E)
    for rank in range(2):
        with tpart.mesh_context(tpart.Mesh(names, shape, rank=rank)):
            for wshard in (None, WorkerShardConfig()):
                state = tcs.init_pool_state(cfg, coding, 2, 8, "cpu",
                                            wshard=wshard)
                assert state.caches[0]["k"].shape[1] == 8   # 16 / 2
            state = tcs.init_pool_state(cfg, TCoding(k=2, s=1, e=1), 3, 8,
                                        "cpu")
            assert state.caches[0]["k"].shape[1] == 11    # 22 / 2
    with tpart.mesh_context(tpart.Mesh(("worker", "model"), (2, 1))):
        with pytest.raises(ValueError, match="pass wshard"):
            tcs.init_pool_state(cfg, coding, 2, 8, "cpu")
    # a dense model's pool on the same mesh: the rank's block
    tc = tconfigs.get_reduced(ARCH)
    with tpart.mesh_context(tpart.Mesh(names, shape, rank=1)):
        state = tcs.init_pool_state(tc, TCoding(k=2, s=1, e=1), 3, 8, "cpu")
    assert state.caches[0]["k"].shape[1] == 11        # 22 / 2


# ------------------------------------------------------------ gloo runs

def _inputs(jc, coding_args, seed):
    """Prompts, fixed next tokens, straggler and attacker masks, noise
    key of a run."""
    k, s, e, g = coding_args
    n1 = JCoding(k=k, s=s, e=e).num_workers
    rng = np.random.RandomState(seed)
    mask = np.ones(n1, np.float32)
    byz = np.zeros(n1, np.float32)
    mask[STRAGGLER % n1] = 0.0
    byz[ATTACKER] = 1.0
    return dict(
        tokens=rng.randint(0, jc.vocab_size, (g * k, PLEN)).astype(np.int32),
        steps=rng.randint(0, jc.vocab_size,
                          (STEPS, g * k, 1)).astype(np.int32),
        mask=mask, byz=byz, key=jax.random.PRNGKey(seed))


def _noise(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _port_run(tc, tp, coding_args, inp, noise, wm, pool):
    """The port's batch round or pool on the active mesh, if any: per
    call (logits, located), and the caches."""
    k, s, e, g = coding_args
    coding = TCoding(k=k, s=s, e=e)
    wshard = WorkerShardConfig(gather_width=coding.num_workers) if wm \
        else None
    kw = dict(straggler_mask=torch.from_numpy(inp["mask"]),
              byz_mask=torch.from_numpy(inp["byz"]),
              byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
              with_report=True, wshard=wshard)
    tokens = {"tokens": torch.from_numpy(inp["tokens"])}
    out = []
    if not pool:
        logits, state, rep = tcs.coded_prefill(tc, coding, tp, tokens,
                                               MAX_LEN, **kw)
        out.append((logits, rep[0]))
        for toks in inp["steps"]:
            logits, state, rep = tcs.coded_decode_step(
                tc, coding, tp, state, torch.from_numpy(toks), **kw)
            out.append((logits, rep[0]))
        return out, state.caches
    state = tcs.init_pool_state(tc, coding, g, MAX_LEN, "cpu",
                                wshard=wshard)
    fresh = tcs.init_caches(tc, tcs.pool_streams(coding, g, wshard),
                            MAX_LEN, torch.float32, "cpu")
    steps = iter(inp["steps"])
    for kind, slots in _pool_calls(g):
        if kind == "prefill":
            logits, state, rep = tcs.coded_pool_prefill(
                tc, coding, tp, state, tokens, slots, fresh, **kw)
        else:
            logits, state, rep = tcs.coded_pool_decode_step(
                tc, coding, tp, state, torch.from_numpy(next(steps)), slots,
                **kw)
        out.append((logits, rep[0]))
    return out, state.caches


def _ref_run(jc, jp, coding_args, inp, pool):
    """The reference's single-device batch round or pool: per call
    (logits, located)."""
    k, s, e, g = coding_args
    jcoding = JCoding(k=k, s=s, e=e)
    kw = dict(straggler_mask=jnp.asarray(inp["mask"]),
              byz_mask=jnp.asarray(inp["byz"]), byz_rng=inp["key"],
              byz_sigma=10.0, with_report=True)
    toks = jnp.asarray(inp["tokens"])
    out = []
    with jops.force_kernel("xla"):
        if not pool:
            jl, st, rep = jax.jit(lambda p, t: jcs.coded_prefill(
                jc, jcoding, p, {"tokens": t}, MAX_LEN, **kw))(jp, toks)
            out.append((np.asarray(jl), np.asarray(rep[0])))
            step = jax.jit(lambda p, st, t: jcs.coded_decode_step(
                jc, jcoding, p, st, t, **kw))
            for t in inp["steps"]:
                jl, st, rep = step(jp, st, jnp.asarray(t))
                out.append((np.asarray(jl), np.asarray(rep[0])))
        else:
            st = jcs.init_pool_state(jc, jcoding, g, MAX_LEN)
            pre = jax.jit(lambda p, st, t, a: jcs.coded_pool_prefill(
                jc, jcoding, p, st, {"tokens": t}, MAX_LEN, a, **kw))
            dec = jax.jit(lambda p, st, t, a: jcs.coded_pool_decode_step(
                jc, jcoding, p, st, t, a, **kw))
            steps = iter(inp["steps"])
            for kind, slots in _pool_calls(g):
                a = jnp.asarray(slots)
                jl, st, rep = (pre(jp, st, toks, a) if kind == "prefill"
                               else dec(jp, st, jnp.asarray(next(steps)), a))
                out.append((np.asarray(jl), np.asarray(rep[0])))
    jax.effects_barrier()
    return out


@pytest.fixture(scope="module")
def cases():
    """Per arch: the reference's config and parameters, the port's
    config and converted parameters."""
    out = {}
    for arch in (ARCH, "mamba2-780m"):
        jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (jc, tc, jp, tp)
    return out


@pytest.fixture(scope="module")
def references(cases):
    """Per run: its inputs and noise, the port's one-rank path (calls,
    vote columns, caches) and, for qwen3 at K=2 S=2 E=1, the reference's
    calls and vote columns (a worker-major run is held to its group-major
    twin's)."""
    runs = {r[0]: r[1:] for name in MESHES for r in _runs(name)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jcols, tcols = capture_columns(mp, jcs, tcs)
        for run, (arch, coding_args, wm, pool) in sorted(runs.items()):
            jc, tc, jp, tp = cases[arch]
            k, s, e, g = coding_args
            inp = _inputs(jc, coding_args, 7 + pool)
            n1 = JCoding(k=k, s=s, e=e).num_workers
            noise = _noise(inp["key"], (g, n1, jc.vocab_size))
            del tcols[:]
            calls, caches = _port_run(tc, tp, coding_args, inp, noise, wm,
                                      pool)
            entry = {"inputs": inp, "noise": noise, "port": calls,
                     "port_cols": list(tcols), "caches": caches}
            if arch == ARCH and coding_args[:3] == (K, S, E) and not wm:
                del jcols[:]
                entry["ref"] = _ref_run(jc, jp, coding_args, inp, pool)
                entry["ref_cols"] = list(jcols)
            out[run] = entry
    for run in ("batch_wm", "pool_wm"):
        twin = out[run.split("_")[0]]
        out[run]["ref"], out[run]["ref_cols"] = twin["ref"], twin["ref_cols"]
    return out


# One rank of a gloo mesh.  argv: rank, world, store, case file, output
# directory, mesh name.
_RANK_SCRIPT = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, case_path, out_dir, name = sys.argv[3:7]
MESHES, MAX_LEN = %(consts)s
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)

from repro_torch import configs
from repro_torch.core.berrut import CodingConfig
from repro_torch.launch import multihost
from repro_torch.launch import worker_mesh as wm
from repro_torch.launch.mesh import make_host_mesh, make_worker_mesh
from repro_torch.models import partitioning
from repro_torch.serving import coded_serving as cs

axes, shape = MESHES[name]
sizes = dict(zip(axes, shape))
mesh = (make_worker_mesh(sizes["worker"], multi_pod=True) if "pod" in sizes
        else make_host_mesh(data=sizes["data"]))
assert mesh.axis_names == tuple(axes) and mesh.shape == tuple(shape)
out = {"block": np.asarray(partitioning.batch_block(64, mesh))}
# host-shard assembly: each rank's two rows hold its rank
rows = {"x": torch.full((2, 3), float(rank))}
out["pool_rows"] = multihost.global_pool_from_host_shard(mesh, rows)["x"]
data = torch.load(case_path)
cols = []
real_locate = cs.locate_groups


def locate_groups(betas, vals, avail, **kw):
    cols.append((vals.clone(), avail.clone()))
    return real_locate(betas, vals, avail, **kw)


cs.locate_groups = locate_groups
with partitioning.mesh_context(mesh):
    out["rank_workers"] = np.asarray(wm.rank_workers(
        CodingConfig(k=2, s=2, e=1), wm.WorkerShardConfig()))
    for run, arch, coding_args, worker_major, pool in data["runs"]:
        cfg = configs.get_reduced(arch)
        k, s, e, g = coding_args
        coding = CodingConfig(k=k, s=s, e=e)
        params = data[arch + "/params"]
        wshard = (wm.WorkerShardConfig(gather_width=coding.num_workers)
                  if worker_major else None)
        kw = dict(straggler_mask=data[run + "/mask"],
                  byz_mask=data[run + "/byz"], byz_noise=data[run + "/noise"],
                  byz_sigma=10.0, with_report=True, wshard=wshard)
        tokens = {"tokens": data[run + "/tokens"]}
        steps = iter(data[run + "/steps"])
        del cols[:]
        mesh.reset_bytes()
        calls = []

        def call(step, *args):
            calls.append(step(cfg, coding, params, *args, **kw))
            for axis, group in mesh.groups.items():
                for op, b in group.collective_bytes().items():
                    out["%%s/bytes%%d/%%s/%%s" %% (run, len(calls) - 1,
                                               axis, op)] = b
            mesh.reset_bytes()
            return calls[-1][1]

        if pool:
            state = cs.init_pool_state(cfg, coding, g, MAX_LEN, "cpu",
                                       wshard=wshard)
            fresh = cs.init_caches(cfg, cs.pool_streams(coding, g, wshard),
                                   MAX_LEN, torch.float32, "cpu")
            for kind, slots in data[run + "/calls"]:
                state = (call(cs.coded_pool_prefill, state, tokens, slots,
                              fresh) if kind == "prefill" else
                         call(cs.coded_pool_decode_step, state, next(steps),
                              slots))
        else:
            state = call(cs.coded_prefill, tokens, MAX_LEN)
            for toks in steps:
                state = call(cs.coded_decode_step, state, toks)
        for i, (logits, _, (located, _)) in enumerate(calls):
            out["%%s/logits%%d" %% (run, i)] = logits.numpy()
            out["%%s/located%%d" %% (run, i)] = located.numpy()
        for i, (vals, avail) in enumerate(cols):
            out["%%s/vals%%d" %% (run, i)] = vals.numpy()
            out["%%s/avail%%d" %% (run, i)] = avail.numpy()
        for i, cache in enumerate(calls[-1][1].caches):
            for leaf, value in cache.items():
                out["%%s/cache%%d/%%s" %% (run, i, leaf)] = value.numpy()
np.savez("%%s/rank%%d.npz" %% (out_dir, rank), **out)
dist.destroy_process_group()
""" % {"consts": (MESHES, MAX_LEN)}


@pytest.fixture(scope="module")
def mesh_runs(cases, references, tmp_path_factory):
    """{mesh: per-rank outputs}: every mesh's ranks started at once, each
    failing rank or one past TIMEOUT_S failing the test."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs, dirs = [], {}
    for name, (_, shape) in MESHES.items():
        tmp = tmp_path_factory.mktemp(name)
        dirs[name] = tmp
        data = {"runs": _runs(name)}
        for arch in {r[1] for r in _runs(name)}:
            data[arch + "/params"] = cases[arch][3]
        for run, arch, coding_args, _, pool in _runs(name):
            ref = references[run]
            for field in ("tokens", "steps", "mask", "byz"):
                data[f"{run}/{field}"] = torch.from_numpy(
                    ref["inputs"][field])
            data[run + "/noise"] = torch.from_numpy(ref["noise"])
            data[run + "/calls"] = [(kind, slots.tolist()) for kind, slots
                                    in _pool_calls(coding_args[3])]
        torch.save(data, tmp / "case.pt")
        world = int(np.prod(shape))
        procs += [(name, r, subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world),
             str(tmp / "store"), str(tmp / "case.pt"), str(tmp), name],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for r in range(world)]
    logs = []
    try:
        for _, _, p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (name, r, p), log in zip(procs, logs):
        assert p.returncode == 0, f"{name} rank {r}:\n{log[-3000:]}"
    return {name: [dict(np.load(dirs[name] / f"rank{r}.npz"))
                   for r in range(int(np.prod(shape)))]
            for name, (_, shape) in MESHES.items()}


def _tokens_up_to_near_tie(got, want, where):
    """Greedy tokens equal, except where ``want``'s top two logits lie
    within the logits' tolerance of each other (a near tie)."""
    gt, wt = got.argmax(-1), want.argmax(-1)
    for row in np.flatnonzero(gt != wt):
        top = np.sort(want[row])[-2:]
        tol = 2 * (LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * abs(top[1]))
        assert top[1] - top[0] <= tol, (where, row, top)
        print(f"{where}: row {row} a near tie ({top[1] - top[0]:.3g})")


def _expected_bytes(name, coding_args, wm, vocab):
    """Analytic per-rank bytes of one call, by group and op (fp32, the
    ring accounting of ``partitioning.WorkerGroup``): the batch group
    ("fsdp": the pod and data axes) all-gathers the coded logits of the
    (padded) streams, or with ``wm`` of the worker's block; on a worker
    axis of W the survivor tail all-gathers the (N+1, G, C_vote) vote
    columns, reduce-scatters the (N+1, G, V) survivor buffer (the gather
    width is N+1) and all-gathers the (G*K, V) decoded rows."""
    axes, shape = MESHES[name]
    sizes = dict(zip(axes, shape))
    w = sizes.get("worker", 1)
    b = sizes.get("pod", 1) * sizes.get("data", 1)
    k, s, e, g = coding_args
    coding = TCoding(k=k, s=s, e=e)
    n1 = coding.num_workers
    rows = g * n1 // w if wm else -(-g * n1 // b) * b
    want = {"fsdp": {"all-gather": (b - 1) / b * 4 * rows * vocab}}
    if wm and w > 1:
        want["worker"] = {
            "all-gather": (w - 1) / w * 4 * (n1 * g * coding.c_vote
                                             + g * k * vocab),
            "reduce-scatter": (w - 1) * 4 * n1 * g * vocab / w}
    for ops in want.values():
        ops["total"] = sum(ops.values())
    return want


def _run_pairs():
    return [(name, r[0]) for name in MESHES for r in _runs(name)]


@pytest.mark.parametrize("name, run", _run_pairs())
def test_batch_axes_run_matches_reference_and_one_rank(name, run, mesh_runs,
                                                       references, cases):
    ranks = mesh_runs[name]
    spec = {r[0]: r[1:] for r in _runs(name)}[run]
    arch, coding_args, wm, pool = spec
    k, s, e, g = coding_args
    coding = TCoding(k=k, s=s, e=e)
    ref = references[run]
    vocab = cases[arch][1].vocab_size
    r0 = ranks[0]
    calls = len(ref["port"])
    for i, (pl, ploc) in enumerate(ref["port"]):
        got = r0[f"{run}/logits{i}"]
        for out in ranks[1:]:                      # the same on every rank
            np.testing.assert_array_equal(out[f"{run}/logits{i}"], got)
            np.testing.assert_array_equal(out[f"{run}/located{i}"],
                                          r0[f"{run}/located{i}"])
        np.testing.assert_allclose(got, pl.numpy(), **LOGITS_TOL)
        _tokens_up_to_near_tie(got, pl.numpy(), f"{name} {run} call {i}")
        if "ref" in ref:
            np.testing.assert_allclose(got, ref["ref"][i][0], **LOGITS_TOL)
            _tokens_up_to_near_tie(got, ref["ref"][i][0],
                                   f"{name} {run} call {i}")
    # verdicts: the reference's where held to it, else the one rank's
    want = ref["ref"] if "ref" in ref else [(None, loc.numpy())
                                            for _, loc in ref["port"]]
    wcols = ref["ref_cols"] if "ref" in ref else [
        (v.numpy(), a.numpy()) for v, a in ref["port_cols"]]
    tcols = [(torch.from_numpy(r0[f"{run}/vals{i}"]),
              torch.from_numpy(r0[f"{run}/avail{i}"])) for i in range(calls)]
    assert near_tie_walk(
        coding, [(i, np.asarray(want[i][1])) for i in range(calls)],
        [(i, r0[f"{run}/located{i}"]) for i in range(calls)], wcols,
        tcols)[0] is None
    assert any(r0[f"{run}/located{i}"][:, ATTACKER].any()
               for i in range(calls))
    # each rank's caches: its block of the one-rank caches (the same
    # layout), real streams only: a padding stream never lands in a slot
    axes, shape = MESHES[name]
    real = g * coding.num_workers
    for rank, out in enumerate(ranks):
        mesh = tpart.Mesh(axes, shape, rank)
        with tpart.mesh_context(mesh):
            padded = real if wm else tcs.num_padded_streams(coding, g)
        start, length = tpart.batch_block(padded, mesh)
        keep = max(0, min(length, real - start))
        for i, cache in enumerate(ref["caches"]):
            for leaf, value in cache.items():
                mine = out[f"{run}/cache{i}/{leaf}"]
                assert mine.shape[1] == length
                np.testing.assert_allclose(
                    mine[:, :keep], value.numpy()[:, start:start + keep],
                    **STATE_TOL, err_msg=f"rank {rank} {leaf}")
    if run.startswith("pad"):
        assert real == 21 and padded == 22
    # bytes by group and op, call by call: nothing on the other groups
    want = _expected_bytes(name, coding_args, wm, vocab)
    for i in range(calls):
        got = {}
        for key, b in r0.items():
            parts = key.split("/")
            if key.startswith(f"{run}/bytes{i}/") and b:
                got.setdefault(parts[2], {})[parts[3]] = float(b)
        assert set(got) == set(want), (i, got)
        for group, ops in want.items():
            for op, b in ops.items():
                assert got[group].get(op, 0.0) == pytest.approx(b), \
                    (i, group, op)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_axes_layout_and_host_assembly(name, mesh_runs):
    """On every rank: ``batch_block`` is its block in the order
    ("worker", "pod", "data"), ``rank_workers`` reads its worker
    coordinate, and ``global_pool_from_host_shard`` gathers the ranks'
    rows in block order (not the mesh's rank order)."""
    axes, shape = MESHES[name]
    ranks = mesh_runs[name]
    order = sorted(range(len(ranks)),
                   key=lambda r: tuple(ranks[r]["block"]))
    for rank, out in enumerate(ranks):
        mesh = tpart.Mesh(axes, shape, rank)
        assert tuple(out["block"]) == tpart.batch_block(64, mesh)
        assert tuple(out["rank_workers"]) == (4 * mesh.coord("worker"),
                                              8 // mesh.size("worker"))
        np.testing.assert_array_equal(
            out["pool_rows"],
            np.repeat(np.asarray(order, np.float32), 2)[:, None]
            * np.ones((1, 3), np.float32))
    if name == "pod2_worker2":                # pod-major ranks, worker-major
        assert order == [0, 2, 1, 3]          # blocks
