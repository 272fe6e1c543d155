"""Port parity of the cache-length split: dense decoders served on a
model axis that does not divide their kv-heads.

The reference keeps the kv-heads whole there and shards the cache length
over "model" (``launch.shardings.cache_rules``), or, where the axis does
not divide the ring width either, keeps the whole ring on every rank
(``resolve_spec``).  The port lays its caches out the same way
(``models.attention.RingBlock``), runs B4/B5's block form over a rank's
slots and merges the ranks' partial softmaxes.

The plain block form (``kernels.ref``, the CPU path of ``kernels.ops``)
and its merge are held, on numpy inputs from a seed, against the
whole-ring plain version and the reference's XLA path.  The gloo runs
spawn one process per rank, as ``tests/test_torch_mesh_serving.py``
does, one run per mesh serving several cases: the batch round
(``coded_prefill`` and two ``coded_decode_step``s, K=2 S=2 E=1 over 2
groups, a straggler, a sigma-10 attacker) and the worker-major slot pool
(prefill and two decode rounds).  The meshes and cases:

- model 4: reduced qwen3 (4 q / 2 kv, one q-head a rank, 4 ring slots a
  rank, two ranks' blocks empty in decode) and reduced h2o-danube (its
  window of 64, prompts of 70 tokens: the ring wraps across ranks);
- model 2: reduced qwen3 with one kv-head (MQA), max_len 16 (ring
  blocks) and 15 (odd: whole caches on every rank);
- (worker, model) = (2, 2): the same MQA config, max_len 16;
- model 3: 6 q / 2 kv (the straddle: rank 1's q-heads 2 and 3 read
  kv-heads 0 and 1) and reduced qwen3, whose 4 q-heads stay whole on
  every rank, both at max_len 15.

Each run is held to the reference's single-device steps and to the
port's one-rank path: logits within ``LOGITS_TOL``, tokens equal up to
near ties, verdicts by ``_torch_parity.near_tie_walk``, each rank's
caches equal to ``local_shard`` of the one-rank caches under
``cache_shardings``, and the model axis's collective bytes by op equal
to the analytic count.
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
from repro.launch import shardings as jshardings  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import shardings as tshardings  # noqa: E402
from repro_torch.launch.worker_mesh import WorkerShardConfig  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import partitioning as tpart  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import check_model_axis  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

from _torch_parity import capture_columns, near_tie_walk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240
BATCH = (2, 2, 1, 2)               # K, S, E, groups: 8 coded streams a group
POOL = 2
STEPS = 2
STRAGGLER, ATTACKER = 6, 1
# name -> (arch, config updates, prompt length, max_len)
CASES = {
    "qwen3": ("qwen3-0.6b", {}, 8, 16),
    "qwen3_whole_q": ("qwen3-0.6b", {}, 8, 15),
    "mqa": ("qwen3-0.6b", {"num_kv_heads": 1}, 8, 16),
    "mqa_odd": ("qwen3-0.6b", {"num_kv_heads": 1}, 8, 15),
    "straddle": ("qwen3-0.6b", {"num_heads": 6}, 8, 15),
    "h2o": ("h2o-danube-1.8b", {}, 70, 74),
}
# name -> ((worker, data, model), cases, each case's cache layout)
MESHES = {
    "model4": ((1, 1, 4), {"qwen3": "ring", "h2o": "ring"}),
    "model2": ((1, 1, 2), {"mqa": "ring", "mqa_odd": "whole"}),
    "worker2_model2": ((2, 1, 2), {"mqa": "ring"}),
    "model3": ((1, 1, 3), {"straddle": "ring", "qwen3_whole_q": "ring"}),
}
PAIRS = [(mesh, case) for mesh in sorted(MESHES)
         for case in sorted(MESHES[mesh][1])]


def _layout(names, shape):
    """The reference's view of a mesh: what its partitioning reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


def _mesh_of(shape, rank=0):
    """The port's layout of a (worker, data, model) mesh, as the ranks'
    ``make_host_mesh`` lays it out (no process groups)."""
    w, d, m = shape
    if w == 1:
        return tpart.Mesh(("data", "model"), (d, m), rank=rank)
    return tpart.Mesh(("worker", "data", "model"), shape, rank=rank)


def _configs(case):
    arch, upd = CASES[case][:2]
    return (jconfigs.get_reduced(arch).with_updates(**upd),
            tconfigs.get_reduced(arch).with_updates(**upd))


# ------------------------------------------------------- plain block form

def _draw(seed, b=5, h=4, kv=2, w=24, d=64, int8=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    if int8:
        k = rng.randint(-127, 128, (b, w, kv, d)).astype(np.int8)
        v = rng.randint(-127, 128, (b, w, kv, d)).astype(np.int8)
    else:
        k = rng.randn(b, w, kv, d).astype(np.float32)
        v = rng.randn(b, w, kv, d).astype(np.float32)
    return q, k, v


def _blocks(m, w):
    n = w // m
    return [(r * n, (r + 1) * n) for r in range(m)]


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_block_form_merges_to_the_whole_ring(m, softcap):
    """The mask form's blocks, merged, are the whole ring's plain decode
    and the reference's XLA decode; rows with no valid key in a block
    give zeros and lse -inf there."""
    q, k, v = _draw(1)
    b, w = q.shape[0], k.shape[1]
    rng = np.random.RandomState(2)
    mask = rng.rand(b, w) < 0.6
    mask[0, :] = False
    mask[0, w - 1] = True              # row 0: one key, in the last block
    mask[1, : w // m] = False          # row 1: its first block empty
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(mask)
    outs, lses = [], []
    for lo, hi in _blocks(m, w):
        o, lse = tops.decode_attention(
            tq, tk[:, lo:hi].contiguous(), tv[:, lo:hi].contiguous(),
            tm[:, lo:hi], softcap=softcap, return_lse=True)
        assert o.dtype == torch.float32 and lse.shape == (b, q.shape[1])
        empty = ~tm[:, lo:hi].any(1)
        assert torch.isneginf(lse[empty]).all()
        assert torch.equal(o[empty], torch.zeros_like(o[empty]))
        assert torch.isfinite(lse[~empty]).all()
        outs.append(o)
        lses.append(lse)
    assert torch.isneginf(lses[0][0]).all()
    merged = tref.merge_blocks_ref(torch.stack(outs), torch.stack(lses))
    whole = tops.decode_attention(tq, tk, tv, tm, softcap=softcap)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **BLOCK_TOL)
    with jops.force_kernel("xla"):
        jwhole = np.asarray(jops.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), softcap=softcap))
    np.testing.assert_allclose(merged.numpy(), jwhole, **BLOCK_TOL)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("int8,softcap", [(False, 0.0), (True, 0.0),
                                          (False, 50.0), (True, 50.0)])
def test_pool_block_form_merges_to_the_whole_ring(m, int8, softcap):
    """The pool form's blocks (``slot0``), merged, are the whole ring's
    pool decode and, on live rows, the reference's XLA decode: streams at
    depths inside, at the edge of and past a block, past the ring (every
    slot valid), and dead streams, which give exact zeros everywhere."""
    q, k, v = _draw(3, b=7, int8=int8)
    w = k.shape[1]
    kv_scale = tattention.INT8_KV_SCALE if int8 else 0.0
    n = w // m
    pos = np.array([0, n - 1, n, w - 2, w + 5, 3, n + 1], np.int32)
    live = np.array([1, 1, 1, 1, 1, 0, 0], np.uint8)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpos, tlive = torch.from_numpy(pos), torch.from_numpy(live)
    outs, lses = [], []
    for lo, hi in _blocks(m, w):
        o, lse = tops.pool_decode_attention(
            tq, tk[:, lo:hi].contiguous(), tv[:, lo:hi].contiguous(), tpos,
            tlive, softcap=softcap, kv_scale=kv_scale, slot0=lo,
            return_lse=True)
        keyless = (tpos < lo) | (tlive == 0)
        assert torch.isneginf(lse[keyless]).all()
        assert torch.isfinite(lse[~keyless]).all()
        assert torch.equal(o[keyless], torch.zeros_like(o[keyless]))
        outs.append(o)
        lses.append(lse)
    merged = tref.merge_blocks_ref(torch.stack(outs), torch.stack(lses))
    dead = live == 0
    assert not merged.isnan().any()
    assert torch.equal(merged[dead], torch.zeros_like(merged[dead]))
    whole = tops.pool_decode_attention(tq, tk, tv, tpos, tlive,
                                       softcap=softcap, kv_scale=kv_scale)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **BLOCK_TOL)
    with jops.force_kernel("xla"):
        jwhole = np.asarray(jops.pool_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), jnp.asarray(live), softcap=softcap,
            kv_scale=kv_scale))
    np.testing.assert_allclose(merged.numpy()[~dead], jwhole[~dead],
                               **BLOCK_TOL)


def test_merge_of_keyless_rows_is_exact_zeros():
    """lse -inf on every block: zeros, never NaN; one block with keys:
    that block's output exactly."""
    outs = torch.randn(3, 2, 4, 8)
    lses = torch.full((3, 2, 4), float("-inf"))
    assert torch.equal(tref.merge_blocks_ref(outs, lses),
                       torch.zeros(2, 4, 8))
    lses[1, 0] = 0.5
    merged = tref.merge_blocks_ref(outs * (lses > float("-inf"))[..., None],
                                   lses)
    assert torch.equal(merged[0], outs[1, 0])
    assert torch.equal(merged[1], torch.zeros(4, 8))


# ------------------------------------------------------- layouts

def test_model_axis_refuses_only_a9_3():
    """No family is refused on a model axis: Mamba2's blocks run on it
    since A9.3b (at a rank's block of the SSM heads where the axis
    divides them, else whole; ``tests/test_torch_ssm_axes.py``), the MoE
    layer and the frontends since A9.3's first part."""
    for arch in tconfigs.list_archs():
        for m in (2, 3, 4, 16):
            check_model_axis(tconfigs.get_config(arch), m)
            check_model_axis(tconfigs.get_reduced(arch), m)


@pytest.mark.parametrize("arch, upd, m, max_len, layout", [
    ("qwen3-0.6b", {}, 16, 256, "ring"),       # the production default
    ("qwen3-0.6b", {}, 16, 133, "whole"),
    ("qwen3-0.6b", {}, 4, 16, "ring"),
    ("qwen3-0.6b", {}, 2, 15, "heads"),
    ("qwen3-0.6b", {"num_kv_heads": 1}, 2, 15, "whole"),
    ("qwen3-0.6b", {"num_heads": 6}, 3, 15, "ring"),
    ("h2o-danube-1.8b", {}, 4, 200, "ring"),   # the window's 64 slots
    ("phi4-mini-3.8b", {}, 3, 12, "ring"),
    ("stablelm-1.6b", {}, 3, 12, "ring"),
])
def test_cache_layout_follows_cache_rules(arch, upd, m, max_len, layout):
    """``init_caches`` on a rank equals ``local_shard`` of the one-rank
    caches under ``cache_shardings`` (whose specs are the reference's),
    for every rank: kv-head blocks, ring-slot blocks (a ``RingBlock``)
    or the whole ring."""
    tc = tconfigs.get_reduced(arch).with_updates(**upd)
    jc = jconfigs.get_reduced(arch).with_updates(**upd)
    whole = tmodel.init_caches(tc, 4, max_len, torch.float32, "cpu")
    for run in whole:
        for leaf in run.values():
            leaf.copy_(torch.randn(leaf.shape))
    jmesh = _layout(("data", "model"), (1, m))
    specs = tshardings.cache_shardings(_mesh_of((1, 1, m)), tc, whole)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshardings, "NamedSharding", lambda mesh, spec: spec)
        want = jshardings.cache_shardings(jmesh, jc, jax.tree.map(
            lambda t: types.SimpleNamespace(shape=tuple(t.shape)),
            [dict(run) for run in whole]))
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert [dict(s) for s in specs] == want
    for rank in range(m):
        mesh = _mesh_of((1, 1, m), rank)
        with tpart.mesh_context(mesh):
            local = tmodel.init_caches(tc, 4, max_len, torch.float32, "cpu")
        blocks = tshardings.local_shard(whole, specs, mesh)
        for mine, blk in zip(local, blocks):
            assert isinstance(mine, tattention.RingBlock) == \
                (layout == "ring")
            for name in ("k", "v"):
                assert mine[name].shape == blk[name].shape
        k = local[0]["k"]
        w = tattention.cache_width(tc, max_len)
        assert k.shape[2:4] == {
            "ring": (w // m, tc.num_kv_heads),
            "whole": (w, tc.num_kv_heads),
            "heads": (w, tc.num_kv_heads // m)}[layout]


@pytest.mark.parametrize("m, max_len, layout", [(4, 16, "ring"),
                                                (3, 16, "whole")])
def test_attention_on_local_shard_caches(m, max_len, layout):
    """Caches cut by ``local_shard`` under ``cache_shardings`` carry no
    ``RingBlock`` type: where the rules split the ring, prefill and both
    decode branches refuse them rather than read a rank's slots as a
    whole ring; a whole ring (the axis divides neither the kv-heads nor
    the width) decodes as on one rank."""
    tc = tconfigs.get_reduced("qwen3-0.6b")
    p = tattention.init_attention(tc, torch.Generator().manual_seed(3),
                                  torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, tc.d_model, generator=g)
    x1 = torch.randn(2, 1, tc.d_model, generator=g)
    pos = torch.tensor([6, 6])
    whole = tmodel.init_caches(tc, 2, max_len, torch.float32, "cpu")
    ring = {k: v[0] for k, v in whole[0].items()}
    tattention.attention_prefill(tc, p, x, torch.arange(6)[None], ring)
    want = [tattention.attention_decode(tc, p, x1, 6, dict(ring))[0],
            tattention.attention_decode(tc, p, x1, pos, dict(ring))[0]]
    mesh = _mesh_of((1, 1, m), 1)
    specs = tshardings.cache_shardings(mesh, tc, whole)
    blocks = tshardings.local_shard(whole, specs, mesh)
    mine = {k: v[0] for k, v in blocks[0].items()}
    with tpart.mesh_context(mesh):
        if layout == "ring":
            for call in (lambda c: tattention.attention_prefill(
                             tc, p, x, torch.arange(6)[None], c),
                         lambda c: tattention.attention_decode(
                             tc, p, x1, 6, c),
                         lambda c: tattention.attention_decode(
                             tc, p, x1, pos, c)):
                with pytest.raises(ValueError, match="RingBlock"):
                    call(dict(mine))
            return
        got = [tattention.attention_decode(tc, p, x1, 6, dict(mine))[0],
               tattention.attention_decode(tc, p, x1, pos, dict(mine))[0]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGITS_TOL)


# ------------------------------------------------------- gloo runs

def _inputs(jc, case, seed, groups):
    """Prompts, fixed next tokens, straggler mask, attacker mask, noise
    key of a round."""
    k, s, e, _ = BATCH
    plen = CASES[case][2]
    n1 = JCoding(k=k, s=s, e=e).num_workers
    rng = np.random.RandomState(seed)
    mask = np.ones(n1, np.float32)
    byz = np.zeros(n1, np.float32)
    mask[STRAGGLER] = 0.0
    byz[ATTACKER] = 1.0
    return dict(
        tokens=rng.randint(0, jc.vocab_size,
                           (groups * k, plen)).astype(np.int32),
        steps=rng.randint(0, jc.vocab_size,
                          (STEPS, groups * k, 1)).astype(np.int32),
        mask=mask, byz=byz, key=jax.random.PRNGKey(seed))


def _noise(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _run(first, step, steps):
    calls = []
    logits, state, rep = first()
    calls.append((logits, rep[0]))
    for toks in steps:
        logits, state, rep = step(state, toks)
        calls.append((logits, rep[0]))
    return calls, state.caches


@pytest.fixture(scope="module")
def references():
    """Per case: the reference's batch round (logits, located and vote
    columns a call), the port's one-rank batch round and worker-major
    pool (the same, and their caches), the inputs and the port's
    converted parameters."""
    k, s, e, g = BATCH
    jcoding, coding = JCoding(k=k, s=s, e=e), TCoding(k=k, s=s, e=e)
    cases = sorted({c for _, cs in MESHES.values() for c in cs})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jcols, tcols = capture_columns(mp, jcs, tcs)
        for case in cases:
            jc, tc = _configs(case)
            max_len = CASES[case][3]
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            inp = _inputs(jc, case, 7, g)
            noise = _noise(inp["key"], (g, jcoding.num_workers,
                                        jc.vocab_size))
            jkw = dict(straggler_mask=jnp.asarray(inp["mask"]),
                       with_report=True, byz_mask=jnp.asarray(inp["byz"]),
                       byz_rng=inp["key"], byz_sigma=10.0)
            del jcols[:], tcols[:]
            jout = []
            with jops.force_kernel("xla"):
                jl, jst, rep = jax.jit(lambda p, t: jcs.coded_prefill(
                    jc, jcoding, p, {"tokens": t}, max_len, **jkw))(
                        jp, jnp.asarray(inp["tokens"]))
                jout.append((np.asarray(jl), np.asarray(rep[0])))
                step = jax.jit(lambda p, st, t: jcs.coded_decode_step(
                    jc, jcoding, p, st, t, **jkw))
                for toks in inp["steps"]:
                    jl, jst, rep = step(jp, jst, jnp.asarray(toks))
                    jout.append((np.asarray(jl), np.asarray(rep[0])))
            jax.effects_barrier()
            ref_cols = list(jcols)
            kw = dict(straggler_mask=torch.from_numpy(inp["mask"]),
                      with_report=True,
                      byz_mask=torch.from_numpy(inp["byz"]),
                      byz_noise=torch.from_numpy(noise), byz_sigma=10.0)
            del tcols[:]
            port, caches = _run(lambda: tcs.coded_prefill(
                tc, coding, tp, {"tokens": torch.from_numpy(inp["tokens"])},
                max_len, **kw), lambda st, t: tcs.coded_decode_step(
                    tc, coding, tp, st, torch.from_numpy(t), **kw),
                inp["steps"])
            entry = {"inputs": inp, "noise": noise, "ref": jout,
                     "ref_cols": ref_cols, "port": port,
                     "port_cols": list(tcols), "caches": caches,
                     "params": tp}
            pinp = _inputs(jc, case, 8, POOL)
            pnoise = _noise(pinp["key"], (POOL, jcoding.num_workers,
                                          jc.vocab_size))
            ws = WorkerShardConfig(gather_width=coding.num_workers)
            state = tcs.init_pool_state(tc, coding, POOL, max_len, "cpu",
                                        wshard=ws)
            fresh = tcs.init_caches(tc, tcs.pool_streams(coding, POOL, ws),
                                    max_len, torch.float32, "cpu")
            ones = np.ones(POOL, np.float32)
            pkw = dict(straggler_mask=torch.from_numpy(pinp["mask"]),
                       byz_mask=torch.from_numpy(pinp["byz"]),
                       byz_noise=torch.from_numpy(pnoise), byz_sigma=10.0,
                       with_report=True, wshard=ws)
            del tcols[:]
            entry["pool"] = _run(lambda: tcs.coded_pool_prefill(
                tc, coding, tp, state,
                {"tokens": torch.from_numpy(pinp["tokens"])}, ones, fresh,
                **pkw), lambda st, t: tcs.coded_pool_decode_step(
                    tc, coding, tp, st, torch.from_numpy(t), ones, **pkw),
                pinp["steps"])
            entry["pool_cols"] = list(tcols)
            entry["pool_inputs"], entry["pool_noise"] = pinp, pnoise
            out[case] = entry
    return out


# One rank of a gloo mesh.  argv: rank, world, store, case file, output
# directory, "W,D,M", the cases as "name,...".
_RANK_SCRIPT = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, case_path, out_dir = sys.argv[3:6]
W, D, M = (int(v) for v in sys.argv[6].split(","))
names = sys.argv[7].split(",")
K, S, E, G = %(batch)r
POOL, STEPS, CASES = %(consts)r
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)

from repro_torch import configs
from repro_torch.core.berrut import CodingConfig
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.worker_mesh import WorkerShardConfig
from repro_torch.models import attention, partitioning
from repro_torch.serving import coded_serving as cs

out = {}
mesh = make_host_mesh(data=D, model=M, worker=W)
data = torch.load(case_path)
cols = []
real_locate = cs.locate_groups


def locate_groups(betas, vals, avail, **kw):
    cols.append((vals.clone(), avail.clone()))
    return real_locate(betas, vals, avail, **kw)


cs.locate_groups = locate_groups


def run_calls(tag, first, step, steps):
    del cols[:]
    mesh.reset_bytes()
    logits, state, rep = first()
    calls = [(logits, rep)]
    for op, b in mesh.group("model").collective_bytes().items():
        out["bytes/%%s/0/%%s" %% (tag, op)] = np.float64(b)
    mesh.reset_bytes()
    for i, toks in enumerate(steps):
        logits, state, rep = step(state, toks)
        calls.append((logits, rep))
        for op, b in mesh.group("model").collective_bytes().items():
            out["bytes/%%s/%%d/%%s" %% (tag, i + 1, op)] = np.float64(b)
        mesh.reset_bytes()
    for i, (logits, (located, votes)) in enumerate(calls):
        out["%%s/logits%%d" %% (tag, i)] = logits.numpy()
        out["%%s/located%%d" %% (tag, i)] = located.numpy()
    for i, (vals, avail) in enumerate(cols):
        out["%%s/vals%%d" %% (tag, i)] = vals.numpy()
        out["%%s/avail%%d" %% (tag, i)] = avail.numpy()
    for i, cache in enumerate(state.caches):
        out["%%s/ring%%d" %% (tag, i)] = np.int32(
            isinstance(cache, attention.RingBlock))
        for name, leaf in cache.items():
            out["%%s/cache%%d/%%s" %% (tag, i, name)] = leaf.numpy()


coding = CodingConfig(k=K, s=S, e=E)
ws = WorkerShardConfig(gather_width=coding.num_workers)
with partitioning.mesh_context(mesh):
    for name in names:
        arch, upd, _, max_len = CASES[name]
        cfg = configs.get_reduced(arch).with_updates(**upd)
        params = data[name + "/params"]
        params = shardings.local_shard(
            params, shardings.serving_param_specs(mesh, cfg, params), mesh)
        kw = dict(straggler_mask=data[name + "/mask"], with_report=True,
                  wshard=ws if W > 1 else None,
                  byz_mask=data[name + "/byz"],
                  byz_noise=data[name + "/noise"], byz_sigma=10.0)
        run_calls(name + "/batch", lambda: cs.coded_prefill(
            cfg, coding, params, {"tokens": data[name + "/tokens"]},
            max_len, **kw), lambda st, t: cs.coded_decode_step(
                cfg, coding, params, st, t, **kw), data[name + "/steps"])
        state = cs.init_pool_state(cfg, coding, POOL, max_len, "cpu",
                                   wshard=ws)
        fresh = cs.init_caches(cfg, cs.pool_streams(coding, POOL, ws),
                               max_len, torch.float32, "cpu")
        ones = np.ones(POOL, np.float32)
        pkw = dict(straggler_mask=data[name + "/pool_mask"],
                   byz_mask=data[name + "/pool_byz"],
                   byz_noise=data[name + "/pool_noise"], byz_sigma=10.0,
                   with_report=True, wshard=ws)
        run_calls(name + "/pool", lambda: cs.coded_pool_prefill(
            cfg, coding, params, state,
            {"tokens": data[name + "/pool_tokens"]}, ones, fresh, **pkw),
            lambda st, t: cs.coded_pool_decode_step(
                cfg, coding, params, st, t, ones, **pkw),
            data[name + "/pool_steps"])
np.savez("%%s/rank%%d.npz" %% (out_dir, rank), **out)
dist.destroy_process_group()
""" % {"batch": BATCH, "consts": (POOL, STEPS, CASES)}


def _spawn(script, args_of_rank, world):
    """Start ``world`` processes; a rank that fails or outlives TIMEOUT_S
    fails the test (every rank is killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script] + args_of_rank(r), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
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
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r][-3000:]}"


@pytest.fixture(scope="module")
def mesh_runs(references, tmp_path_factory):
    """``get(mesh)``: the per-rank outputs of ``mesh``'s gloo run, run
    once on first use."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _run_mesh(name, references, tmp_path_factory)
        return done[name]

    return get


def _run_mesh(name, references, tmp_path_factory):
    (w, d, m), cases = MESHES[name]
    world = w * d * m
    tmp = tmp_path_factory.mktemp(name)
    data = {}
    for case in cases:
        ref = references[case]
        data[case + "/params"] = ref["params"]
        for prefix, inp in (("", ref["inputs"]),
                            ("pool_", ref["pool_inputs"])):
            for field in ("tokens", "steps", "mask", "byz"):
                data[f"{case}/{prefix}{field}"] = torch.from_numpy(
                    inp[field])
        data[case + "/noise"] = torch.from_numpy(ref["noise"])
        data[case + "/pool_noise"] = torch.from_numpy(ref["pool_noise"])
    torch.save(data, tmp / "case.pt")
    _spawn(_RANK_SCRIPT, lambda r: [
        str(r), str(world), str(tmp / "store"), str(tmp / "case.pt"),
        str(tmp), f"{w},{d},{m}", ",".join(sorted(cases))], world)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _tokens_up_to_near_tie(got, want, where):
    """Greedy tokens equal, except where ``want``'s top two logits lie
    within the logits' tolerance of each other (a near tie)."""
    gt, wt = got.argmax(-1), want.argmax(-1)
    for row in np.flatnonzero(gt != wt):
        top = np.sort(want[row])[-2:]
        tol = 2 * (LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * abs(top[1]))
        assert top[1] - top[0] <= tol, (where, row, top)
        print(f"{where}: row {row} a near tie ({top[1] - top[0]:.3g})")


def _expected_model_bytes(cfg, shape, layout, call, pool):
    """Analytic per-rank bytes of one call on the model axis, fp32, ring
    accounting: the vocabulary-split embedding's all-reduce, the
    attention output's and the MLP's all-reduces where those leaves are
    split, the logits' all-gather; and in a decode call, per layer, the
    gathered q-heads (a block of the q-heads against whole kv-heads), and
    with ring blocks the gathered lse and the merge (a reduce-scatter over
    the heads, or an all-reduce where the q-heads are whole)."""
    w, _, m = shape
    k, s, e, g = BATCH
    n1 = TCoding(k=k, s=s, e=e).num_workers
    groups = POOL if pool else g
    local = groups * n1 // w
    seq = CASES[layout[0]][2] if call == 0 else 1
    frac = (m - 1) / m
    d, h, hd, layers = cfg.d_model, cfg.num_heads, cfg.head_dim, \
        cfg.num_layers
    want = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0}
    if cfg.vocab_size % m == 0:
        want["all-reduce"] += 2 * frac * 4 * groups * k * seq * d
        want["all-gather"] += frac * 4 * local * cfg.vocab_size
    per_layer = int(h % m == 0) + int(cfg.d_ff % m == 0)
    want["all-reduce"] += per_layer * layers * 2 * frac * 4 * local * seq * d
    if call > 0:
        q_split = h % m == 0
        if q_split:
            want["all-gather"] += layers * frac * 4 * local * h * hd
        if layout[1] == "ring":
            want["all-gather"] += layers * frac * 4 * m * local * h
            if q_split:
                want["reduce-scatter"] += layers * (m - 1) * 4 * local \
                    * (h // m) * hd
            else:
                want["all-reduce"] += layers * 2 * frac * 4 * local * h * hd
    want = {op: b for op, b in want.items() if b}
    want["total"] = sum(want.values())
    return want


def _worker_major(leaf, g, n1):
    """A group-major (layers, g * n1, ...) cache leaf in worker-major
    stream order (stream n * g + g')."""
    blk = leaf.reshape(leaf.shape[0], g, n1, *leaf.shape[2:])
    return blk.swapaxes(1, 2).reshape(leaf.shape)


def _hold_caches(where, ranks, whole, shape, tc, key, layout, g):
    """Each rank's caches: ``local_shard`` of the one-rank caches under
    ``cache_shardings`` on its mesh, the layout the case names.  At
    W > 1 the batch round's one-rank caches are group-major and the
    ranks' worker-major."""
    w = shape[0]
    n1 = TCoding(k=BATCH[0], s=BATCH[1], e=BATCH[2]).num_workers
    whole = [{name: torch.from_numpy(
        _worker_major(leaf.numpy(), g, n1) if w > 1 and key.endswith(
            "/batch") else leaf.numpy()) for name, leaf in run.items()}
        for run in whole]
    specs = tshardings.cache_shardings(_mesh_of(shape), tc, whole)
    for rank, out in enumerate(ranks):
        blocks = tshardings.local_shard(whole, specs, _mesh_of(shape, rank))
        for i, blk in enumerate(blocks):
            assert out[f"{key}/ring{i}"] == (layout == "ring"), where
            for name, leaf in blk.items():
                np.testing.assert_allclose(
                    out[f"{key}/cache{i}/{name}"], leaf.numpy(),
                    **STATE_TOL, err_msg=f"{where} rank {rank} {name}")


@pytest.mark.parametrize("name, case", PAIRS)
def test_batch_round_matches_reference_and_one_rank(name, case, mesh_runs,
                                                    references):
    ranks = mesh_runs(name)
    shape, layouts = MESHES[name]
    k, s, e, g = BATCH
    coding = TCoding(k=k, s=s, e=e)
    ref = references[case]
    tc = _configs(case)[1]
    key = f"{case}/batch"
    r0 = ranks[0]
    calls = len(ref["ref"])
    for i, ((jl, _), (pl, _)) in enumerate(zip(ref["ref"], ref["port"])):
        got = r0[f"{key}/logits{i}"]
        for out in ranks[1:]:                  # the same on every rank
            np.testing.assert_array_equal(out[f"{key}/logits{i}"], got)
            np.testing.assert_array_equal(out[f"{key}/located{i}"],
                                          r0[f"{key}/located{i}"])
        np.testing.assert_allclose(got, jl, **LOGITS_TOL)
        np.testing.assert_allclose(got, pl.numpy(), **LOGITS_TOL)
        _tokens_up_to_near_tie(got, jl, f"{name} {case} call {i}")
        _tokens_up_to_near_tie(got, pl.numpy(), f"{name} {case} call {i}")
    jrounds = [(i, ref["ref"][i][1]) for i in range(calls)]
    trounds = [(i, r0[f"{key}/located{i}"]) for i in range(calls)]
    tcols = [(torch.from_numpy(r0[f"{key}/vals{i}"]),
              torch.from_numpy(r0[f"{key}/avail{i}"])) for i in range(calls)]
    assert near_tie_walk(coding, jrounds, trounds, ref["ref_cols"],
                         tcols)[0] is None
    assert all(r0[f"{key}/located{i}"][:, ATTACKER].all()
               for i in range(calls))
    _hold_caches(f"{name} {case} batch", ranks, ref["caches"], shape, tc,
                 key, layouts[case], g)
    for i in range(calls):
        want = _expected_model_bytes(tc, shape, (case, layouts[case]), i,
                                     False)
        got = {op[len(f"bytes/{key}/{i}/"):]: b for op, b in r0.items()
               if op.startswith(f"bytes/{key}/{i}/")}
        assert got == pytest.approx(want), (i, got, want)


@pytest.mark.parametrize("name, case", PAIRS)
def test_pool_matches_one_rank(name, case, mesh_runs, references):
    ranks = mesh_runs(name)
    shape, layouts = MESHES[name]
    k, s, e, _ = BATCH
    coding = TCoding(k=k, s=s, e=e)
    ref = references[case]
    tc = _configs(case)[1]
    key = f"{case}/pool"
    calls, caches = ref["pool"]
    r0 = ranks[0]
    for i, (pl, _) in enumerate(calls):
        got = r0[f"{key}/logits{i}"]
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"{key}/logits{i}"], got)
        np.testing.assert_allclose(got, pl.numpy(), **LOGITS_TOL)
        _tokens_up_to_near_tie(got, pl.numpy(), f"{name} {case} pool {i}")
    jrounds = [(i, calls[i][1].numpy()) for i in range(len(calls))]
    trounds = [(i, r0[f"{key}/located{i}"]) for i in range(len(calls))]
    jcols = [(v.numpy(), a.numpy()) for v, a in ref["pool_cols"]]
    tcols = [(torch.from_numpy(r0[f"{key}/vals{i}"]),
              torch.from_numpy(r0[f"{key}/avail{i}"]))
             for i in range(len(calls))]
    assert near_tie_walk(coding, jrounds, trounds, jcols, tcols)[0] is None
    _hold_caches(f"{name} {case} pool", ranks, caches, shape, tc, key,
                 layouts[case], POOL)
    for i in range(len(calls)):
        want = _expected_model_bytes(tc, shape, (case, layouts[case]), i,
                                     True)
        got = {op[len(f"bytes/{key}/{i}/"):]: b for op, b in r0.items()
               if op.startswith(f"bytes/{key}/{i}/")}
        assert got == pytest.approx(want), (i, got, want)
