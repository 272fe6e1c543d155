"""Port parity of worker-sharded coded serving (DESIGN.md §13):
``repro_torch.launch.worker_mesh``, the worker-major branches of the
serving steps and executors, and ``launch.multihost --mode serve``.

In one process (the one-rank path, the reference off any mesh, as
``tests/test_worker_mesh.py`` runs it) the worker-major steps are held
against the reference's on reduced qwen3-0.6b, K=2 S=2 E=1 (8 coded
streams, quorum 4) with exactly the quorum surviving: logits within
rtol 1e-5, atol 1e-4 (another summation order in every product), greedy
tokens and ``located`` exactly; the attacker's noise is the reference's
own draw, handed to both layouts.

Across processes the W > 1 logic runs on gloo: W in {2, 4, 8} processes
over a file store, one thread each.  Sampled tokens over a prefill and
3 decode rounds (greedy, and top-k 3 at temperature 0.7 from one seed)
must be bitwise equal to the one-rank path and to the group-major path,
greedy tokens equal to the reference's; the survivor gather must move
fewer bytes than the replicated baseline by the worker group's own
count; a vocabulary that W does not divide (1001) takes the all-reduce
branch and gives the one-rank result bitwise.  Each multi-process run
has a time limit, so a hang fails instead of stalling the suite.
"""

import inspect
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.configs import mamba2_780m as jmcfg  # noqa: E402
from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import worker_mesh as jwm  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro_torch.configs import mamba2_780m as tmcfg  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.core.berrut import encode_matrix  # noqa: E402
from repro_torch.kernels import berrut_matmul, ops  # noqa: E402
from repro_torch.launch import worker_mesh as twm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving.sampling import (SampleConfig,  # noqa: E402
                                          sample_tokens)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
K, S, E = 2, 2, 1                  # 8 coded streams, quorum 4
POOL, PLEN, STEPS = 2, 8, 3
MAX_LEN = PLEN + STEPS + 8
QUORUM = [0, 2, 5, 7]              # exactly the quorum survives
SAMPLES = {"greedy": SampleConfig(),
           "topk": SampleConfig(top_k=3, temperature=0.7)}
TIMEOUT_S = 240


def _mask(n1, alive=QUORUM):
    m = np.zeros((n1,), np.float32)
    m[alive] = 1.0
    return m


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


# ------------------------------------------------------------ config, slots

def test_worker_shard_config_validation():
    with pytest.raises(ValueError):
        twm.WorkerShardConfig(mode="bogus")
    with pytest.raises(ValueError):
        twm.WorkerShardConfig(gather_width=0)
    coding = TCoding(k=2, s=2, e=1)
    jcoding = JCoding(k=2, s=2, e=1)
    for width in (None, 6, 99):
        assert (twm.WorkerShardConfig(gather_width=width)
                .resolved_width(coding)
                == jwm.WorkerShardConfig(gather_width=width)
                .resolved_width(jcoding))
    assert twm.WorkerShardConfig().resolved_width(coding) == 4
    assert twm.WorkerShardConfig(gather_width=99).resolved_width(coding) == 8


def test_validate_layout_off_any_group():
    wshard = twm.WorkerShardConfig()
    coding = TCoding(k=2, s=2, e=1)
    assert twm.worker_axis_size(wshard) == 1
    assert twm.validate_layout(coding, wshard) == 1
    assert twm.rank_workers(coding, wshard) == (0, 8)


SLOT_MASKS = {
    "four_of_eight": [1, 0, 1, 1, 0, 1, 0, 0],
    "one_survivor": [0, 1, 0, 0, 0, 0, 0, 0],
    "more_than_width": [1, 1, 1, 0, 1, 1, 1, 1],
    "none": [0, 0, 0, 0, 0, 0, 0, 0],
}


@pytest.mark.parametrize("case", sorted(SLOT_MASKS))
def test_survivor_slots_match_reference(case):
    avail = np.asarray(SLOT_MASKS[case], np.float32)
    got = twm._survivor_slots(torch.from_numpy(avail), 4)
    want = jwm._survivor_slots(jnp.asarray(avail), 4)
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    if case == "four_of_eight":
        assert got[0].tolist() == [0, 4, 1, 2, 4, 3, 4, 4]
        assert got[1].tolist() == [0, 2, 3, 5]


# ------------------------------------------------------------ B6, plain path

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 3])
def test_encode_dispatch_plain_matches_reference(dtype, groups):
    coding = TCoding(k=3, s=2, e=1)
    rng = np.random.RandomState(groups)
    x = rng.randn(groups, coding.k, 1000).astype(np.float32)
    w = encode_matrix(coding).to(torch.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.berrut_encode_dispatch(w, tx)
    want = jref.berrut_encode_dispatch_ref(
        jnp.asarray(w.numpy()), jnp.asarray(x).astype(getattr(jnp, dtype)))
    assert got.dtype == tx.dtype and got.shape == (coding.num_workers
                                                   * groups, 1000)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    # worker-major = the group-major contraction, permuted, exactly
    gm = ops.berrut_apply(w, tx)
    assert torch.equal(got, gm.transpose(0, 1).reshape(-1, 1000))


@pytest.mark.parametrize("ranks", [1, 2, 4, 8, 16])
def test_encode_dispatch_row_slices_are_slices_of_the_output(ranks):
    rng = np.random.RandomState(ranks)
    w = torch.from_numpy(rng.randn(16, 7).astype(np.float32))
    x = torch.from_numpy(rng.randn(3, 7, 50).astype(np.float32))
    full = ops.berrut_encode_dispatch(w, x)
    nl = 16 // ranks
    for r in range(ranks):
        part = ops.berrut_encode_dispatch(w[r * nl:(r + 1) * nl], x)
        assert torch.equal(part, full[r * nl * 3:(r + 1) * nl * 3])


def test_encode_dispatch_kernel_wrapper_refuses_cpu_tensors():
    w = torch.ones(4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        berrut_matmul.berrut_encode_dispatch(w, torch.ones(1, 2, 8))


# ------------------------------------------------------------ serving steps

def _noise(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("e", [0, 1])
def test_worker_major_batch_steps_match_reference(model, e):
    jc, tc, jp, tp = model
    jcoding, tcoding = JCoding(k=K, s=S, e=e), TCoding(k=K, s=S, e=e)
    n1 = jcoding.num_workers
    g = 2
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, jc.vocab_size, (g * K, PLEN)).astype(np.int32)
    alive = QUORUM if e else [0, 1]
    m = _mask(n1, alive)
    byz = np.zeros(n1, np.float32)
    if e:
        byz[2] = 1.0
    key = jax.random.PRNGKey(11)
    jws, tws = jwm.WorkerShardConfig(), twm.WorkerShardConfig()
    jkw = dict(straggler_mask=jnp.asarray(m), byz_mask=jnp.asarray(byz),
               byz_rng=key, byz_sigma=10.0, with_report=True, wshard=jws)
    with jops.force_kernel("xla"):
        jl, jst, (jloc, _) = jax.jit(lambda p, t: jcs.coded_prefill(
            jc, jcoding, p, {"tokens": t}, MAX_LEN, **jkw))(
                jp, jnp.asarray(tokens))
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        jl2, _, (jloc2, _) = jax.jit(lambda p, st, t: jcs.coded_decode_step(
            jc, jcoding, p, st, t, **jkw))(jp, jst, nxt)
    noise = torch.from_numpy(_noise(key, (g, n1, jc.vocab_size)))
    outs = {}
    for name, ws in (("worker_major", tws), ("group_major", None)):
        tkw = dict(straggler_mask=torch.from_numpy(m),
                   byz_mask=torch.from_numpy(byz), byz_noise=noise,
                   byz_sigma=10.0, with_report=True, wshard=ws)
        tl, tst, (tloc, _) = tcs.coded_prefill(
            tc, tcoding, tp, {"tokens": torch.from_numpy(tokens)}, MAX_LEN,
            **tkw)
        tl2, tst, (tloc2, _) = tcs.coded_decode_step(
            tc, tcoding, tp, tst, torch.from_numpy(np.array(nxt)), **tkw)
        outs[name] = (tl, tl2, tloc, tloc2)
    tl, tl2, tloc, tloc2 = outs["worker_major"]
    for got, want in ((tl, jl), (tl2, jl2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGITS_TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(want, -1)))
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(tloc2.numpy(), np.asarray(jloc2))
    if e:
        assert tloc.numpy()[:, 2].all()
    # the group-major path decodes the same rows from the same streams
    gl, gl2, gloc, _ = outs["group_major"]
    np.testing.assert_allclose(tl.numpy(), gl.numpy(), **LOGITS_TOL)
    assert torch.equal(tl.argmax(-1), gl.argmax(-1))
    assert torch.equal(tl2.argmax(-1), gl2.argmax(-1))
    assert torch.equal(tloc, gloc)


# per round: (admitted slots, active slots)
ROUNDS = [((0,), ()), ((1,), (0,)), ((), (0, 1)), ((0,), (1,))]


@pytest.mark.parametrize("e", [0, 1])
def test_worker_major_pool_steps_match_reference(model, e):
    jc, tc, jp, tp = model
    jcoding, tcoding = JCoding(k=K, s=S, e=e), TCoding(k=K, s=S, e=e)
    n1 = jcoding.num_workers
    jws, tws = jwm.WorkerShardConfig(), twm.WorkerShardConfig()
    rng = np.random.RandomState(30 + e)
    byz = np.zeros(n1, np.float32)
    if e:
        byz[5] = 1.0
    m = _mask(n1, QUORUM if e else [1, 3])
    jprefill = jax.jit(
        lambda p, st, t, a, bm, br: jcs.coded_pool_prefill(
            jc, jcoding, p, st, {"tokens": t}, MAX_LEN, a,
            straggler_mask=jnp.asarray(m), byz_mask=bm, byz_rng=br,
            byz_sigma=10.0, with_report=True, wshard=jws))
    jdecode = jax.jit(
        lambda p, st, t, a, bm, br: jcs.coded_pool_decode_step(
            jc, jcoding, p, st, t, a, straggler_mask=jnp.asarray(m),
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True,
            wshard=jws))
    jstate = jcs.init_pool_state(jc, jcoding, POOL, MAX_LEN)
    tstate = tcs.init_pool_state(tc, tcoding, POOL, MAX_LEN, "cpu",
                                 wshard=tws)
    fresh = tcs.init_caches(tc, tcs.pool_streams(tcoding, POOL, tws),
                            MAX_LEN, torch.float32, "cpu")
    prompts = np.zeros((POOL * K, PLEN), np.int32)
    nxt = np.zeros((POOL * K, 1), np.int32)
    key = jax.random.PRNGKey(5)
    with jops.force_kernel("xla"):
        for admitted, active in ROUNDS:
            key, sub = jax.random.split(key)
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(_noise(
                             sub, (POOL, n1, jc.vocab_size))),
                         byz_sigma=10.0, with_report=True, wshard=tws)
            calls = []
            if admitted:
                a = np.zeros(POOL, np.float32)
                a[list(admitted)] = 1.0
                for s in admitted:
                    prompts[s * K:(s + 1) * K] = rng.randint(
                        0, jc.vocab_size, (K, PLEN))
                jl, jstate, jrep = jprefill(jp, jstate, jnp.asarray(prompts),
                                            jnp.asarray(a), jnp.asarray(byz),
                                            sub)
                tl, tstate, trep = tcs.coded_pool_prefill(
                    tc, tcoding, tp, tstate,
                    {"tokens": torch.from_numpy(prompts)}, a, fresh, **targs)
                calls.append((a, jl, jrep, tl, trep))
            if active:
                a = np.zeros(POOL, np.float32)
                a[list(active)] = 1.0
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt),
                                           jnp.asarray(a), jnp.asarray(byz),
                                           sub)
                tl, tstate, trep = tcs.coded_pool_decode_step(
                    tc, tcoding, tp, tstate, torch.from_numpy(nxt), a,
                    **targs)
                calls.append((a, jl, jrep, tl, trep))
            for a, jl, (jloc, _), tl, (tloc, _) in calls:
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           **LOGITS_TOL)
                toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
                np.testing.assert_array_equal(tl.argmax(-1).numpy(), toks)
                np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
                rows = np.repeat(a > 0, K)
                assert not tl.numpy()[~rows].any()     # free rows zeroed
                nxt[rows, 0] = toks[rows]
                if e:
                    assert tloc.numpy()[a > 0, 5].all()
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(jstate.pos))
    # the pool caches are the reference's worker-major streams (stream
    # n*P + p).  At E=0 the live mask reaches attention, so the slot that
    # was free in the last decode (0) holds another garbage entry than
    # the reference's there (ROADMAP C): compare slot 1's streams only.
    streams = slice(None) if e else slice(1, None, POOL)
    for jcache, tcache in zip(jstate.caches, tstate.caches):
        for name, leaf in tcache.items():
            np.testing.assert_allclose(
                leaf[:, streams].numpy(),
                np.asarray(jcache[name])[:, streams], **STATE_TOL)


def _serve_pool(executor, prompts, mask, steps=STEPS):
    """Prefill every slot, then ``steps`` decode rounds; the stacked
    (1 + steps, P*K) token ids."""
    ones = np.ones((executor.pool_groups,), np.float32)
    state = executor.init_state()
    toks, state, _ = executor.prefill(state, prompts, ones, mask)
    out = [np.asarray(toks)]
    for _ in range(steps):
        toks, state, _ = executor.decode(
            state, np.asarray(toks).reshape(-1, 1), ones, mask)
        out.append(np.asarray(toks))
    return np.stack(out)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return rng.randint(0, vocab, (POOL * K, PLEN)).astype(np.int32)


@pytest.fixture(scope="module")
def reference_tokens(model):
    """The reference's W=1 worker-major greedy tokens, off any mesh."""
    jc, _, jp, _ = model
    coding = JCoding(k=K, s=S, e=E)
    with jops.force_kernel("xla"):
        ex = jcont.ContinuousLLMExecutor(
            jc, coding, jp, pool_groups=POOL, max_len=MAX_LEN,
            wshard=jwm.WorkerShardConfig())
        return _serve_pool(ex, _prompts(jc.vocab_size),
                           _mask(coding.num_workers))


@pytest.fixture(scope="module")
def one_rank_tokens(model):
    """The port in one process: {(layout, sample): tokens}."""
    _, tc, _, tp = model
    coding = TCoding(k=K, s=S, e=E)
    out = {}
    for layout, ws in (("worker_major", twm.WorkerShardConfig()),
                       ("group_major", None)):
        for name, sample in SAMPLES.items():
            ex = tcont.ContinuousLLMExecutor(
                tc, coding, tp, pool_groups=POOL, max_len=MAX_LEN,
                sample=sample, sample_seed=7, wshard=ws)
            out[layout, name] = _serve_pool(ex, _prompts(tc.vocab_size),
                                            _mask(coding.num_workers))
    return out


def test_continuous_executor_worker_major_matches_reference(
        reference_tokens, one_rank_tokens):
    np.testing.assert_array_equal(
        one_rank_tokens["worker_major", "greedy"], reference_tokens)
    for name in SAMPLES:
        np.testing.assert_array_equal(
            one_rank_tokens["worker_major", name],
            one_rank_tokens["group_major", name])


def test_mamba2_worker_major_pool_round_matches_reference():
    jc, tc = jmcfg.reduced(), tmcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jcoding, tcoding = JCoding(k=K, s=S, e=E), TCoding(k=K, s=S, e=E)
    m = _mask(jcoding.num_workers)
    admit = np.asarray([0.0, 1.0], np.float32)      # slot 1 only
    prompts = _prompts(jc.vocab_size)
    jws, tws = jwm.WorkerShardConfig(), twm.WorkerShardConfig()
    with jops.force_kernel("xla"):
        jl, jstate = jcs.coded_pool_prefill(
            jc, jcoding, jp, jcs.init_pool_state(jc, jcoding, POOL, MAX_LEN),
            {"tokens": jnp.asarray(prompts)}, MAX_LEN, jnp.asarray(admit),
            straggler_mask=jnp.asarray(m), wshard=jws)
    tstate = tcs.init_pool_state(tc, tcoding, POOL, MAX_LEN, "cpu",
                                 wshard=tws)
    fresh = tcs.init_caches(tc, tcs.pool_streams(tcoding, POOL, tws),
                            MAX_LEN, torch.float32, "cpu")
    tl, tstate = tcs.coded_pool_prefill(
        tc, tcoding, tp, tstate, {"tokens": torch.from_numpy(prompts)},
        admit, fresh, straggler_mask=torch.from_numpy(m), wshard=tws)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
    merged = 0
    for jcache, tcache in zip(jstate.caches, tstate.caches):
        for name, leaf in tcache.items():
            # stream n*P + p: only slot 1's streams (odd) were merged
            assert not leaf[:, 0::2].any()
            merged += int(leaf[:, 1::2].abs().sum() > 0)
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jcache[name]), **STATE_TOL)
    assert merged
    assert tstate.pos.tolist() == [0, PLEN]


def test_scheduler_rejects_narrow_gather_width(model):
    _, tc, _, tp = model
    coding = TCoding(k=K, s=S, e=E)            # quorum 4 of 8
    narrow = tcont.ContinuousLLMExecutor(
        tc, coding, tp, pool_groups=POOL, max_len=16,
        wshard=twm.WorkerShardConfig())
    with pytest.raises(ValueError, match="gather width"):
        tcont.ContinuousScheduler(
            tcont.ContinuousConfig(coding=coding, pool_groups=POOL,
                                   wait_for=6), tlat.LatencyModel(), narrow)
    wide = tcont.ContinuousLLMExecutor(
        tc, coding, tp, pool_groups=POOL, max_len=16,
        wshard=twm.WorkerShardConfig(gather_width=6))
    tcont.ContinuousScheduler(
        tcont.ContinuousConfig(coding=coding, pool_groups=POOL, wait_for=6),
        tlat.LatencyModel(), wide)


# ------------------------------------------------------------ W > 1 on gloo

# Tied logits for the top-k tie order (made by the tests and by each
# rank): a (N+1, POOL, 1024) coded block whose workers all hold the same
# values on a 1/4 grid, so the decoded rows keep the ties exactly (every
# decode weight multiplies the same value).
TIED_SAMPLE = SampleConfig(top_k=50, temperature=1.0)
TIED_DRAWS = 8


def tied_block(n1):
    gen = torch.Generator().manual_seed(4)
    row = torch.round(torch.randn((POOL, 1024), generator=gen) * 4) / 4
    return row[None].expand(n1, POOL, 1024).contiguous()


_TIED = (f"TIED_SAMPLE = SampleConfig(top_k={TIED_SAMPLE.top_k}, "
         f"temperature={TIED_SAMPLE.temperature})\n"
         f"TIED_DRAWS = {TIED_DRAWS}\n\n" + inspect.getsource(tied_block))


# One rank of a gloo worker group.  argv: rank, world, store, params,
# output directory.  Serves the pool as the one-rank fixtures do, counts
# one decode call's collective bytes in each mode, and decodes a
# synthetic block whose vocabulary W does not divide.
_RANK_SCRIPT = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, params_path, out_dir = sys.argv[3:6]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)

from repro_torch.configs import qwen3_0_6b
from repro_torch.core.berrut import CodingConfig
from repro_torch.launch import worker_mesh as wm
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import partitioning
from repro_torch.serving.continuous import ContinuousLLMExecutor
from repro_torch.serving.sampling import SampleConfig

K, S, E, POOL, PLEN, STEPS = %(consts)s
%(tied)s
cfg = qwen3_0_6b.reduced()
params = torch.load(params_path)
coding = CodingConfig(k=K, s=S, e=E)
n1 = coding.num_workers
mask = np.zeros((n1,), np.float32)
mask[%(quorum)s] = 1.0
ones = np.ones((POOL,), np.float32)
prompts = np.random.RandomState(0).randint(
    0, cfg.vocab_size, (POOL * K, PLEN)).astype(np.int32)
group = make_worker_mesh(world)
out = {}
with partitioning.worker_group_context(group):
    for name, sample in (("greedy", SampleConfig()),
                         ("topk", SampleConfig(top_k=3, temperature=0.7))):
        ex = ContinuousLLMExecutor(cfg, coding, params, pool_groups=POOL,
                                   max_len=PLEN + STEPS + 8, sample=sample,
                                   sample_seed=7,
                                   wshard=wm.WorkerShardConfig())
        state = ex.init_state()
        toks, state, _ = ex.prefill(state, prompts, ones, mask)
        rows = [toks]
        for _ in range(STEPS):
            toks, state, _ = ex.decode(state, toks.reshape(-1, 1), ones,
                                       mask)
            rows.append(toks)
        out["tokens_" + name] = np.stack(rows)
    for mode in ("survivor", "replicated"):
        ex = ContinuousLLMExecutor(cfg, coding, params, pool_groups=POOL,
                                   max_len=PLEN + STEPS + 8,
                                   wshard=wm.WorkerShardConfig(mode=mode))
        state = ex.init_state()
        toks, state, _ = ex.prefill(state, prompts, ones, mask)
        group.reset_bytes()
        toks, state, _ = ex.decode(state, toks.reshape(-1, 1), ones, mask)
        out["tokens_" + mode] = toks
        for op, b in group.collective_bytes().items():
            out["bytes_%%s_%%s" %% (mode, op)] = np.float64(b)
    # a vocabulary W does not divide: the all-reduce branch
    gen = torch.Generator().manual_seed(3)
    block = torch.randn((n1, POOL, 1001), generator=gen)
    nl = n1 // world
    local = block[rank * nl:(rank + 1) * nl]
    masks = torch.from_numpy(mask)[None].expand(POOL, n1)
    group.reset_bytes()
    out["odd_vocab_logits"] = wm.survivor_decode_tail(
        coding, local, masks, torch.from_numpy(mask),
        wm.WorkerShardConfig()).numpy()
    out["odd_vocab_tokens"] = wm.survivor_decode_tail(
        coding, local, masks, torch.from_numpy(mask),
        wm.WorkerShardConfig(), sample=SampleConfig()).numpy()
    out["odd_vocab_ops"] = np.asarray(sorted(group.collective_bytes()))
    # tied logits: top-k draws from the vocabulary-sharded candidates
    tied = tied_block(n1)
    gen = torch.Generator().manual_seed(5)
    out["tied_tokens"] = np.stack([wm.survivor_decode_tail(
        coding, tied[rank * nl:(rank + 1) * nl], masks,
        torch.from_numpy(mask), wm.WorkerShardConfig(),
        sample=TIED_SAMPLE, generator=gen).numpy() for _ in range(TIED_DRAWS)])
np.savez("%%s/rank%%d.npz" %% (out_dir, rank), **out)
dist.destroy_process_group()
""" % {"consts": (K, S, E, POOL, PLEN, STEPS), "quorum": QUORUM,
       "tied": _TIED}


def _run_ranks(world, tmp_path, params_path):
    """Start ``world`` rank processes; their outputs, rank by rank.  A
    rank that fails or outlives TIMEOUT_S fails the test (every rank is
    killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    store = tmp_path / f"store{world}"
    out_dir = tmp_path / f"w{world}"
    out_dir.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), str(store),
         str(params_path), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def params_file(model, tmp_path_factory):
    path = tmp_path_factory.mktemp("params") / "qwen3_reduced.pt"
    torch.save(model[3], path)
    return path


@pytest.fixture(scope="module", params=[2, 4, 8])
def gloo_ranks(request, params_file, tmp_path_factory):
    world = request.param
    return world, _run_ranks(world, tmp_path_factory.mktemp(f"gloo{world}"),
                             params_file)


def test_gloo_tokens_bitwise_equal_one_rank_and_group_major(
        gloo_ranks, one_rank_tokens):
    _, ranks = gloo_ranks
    for out in ranks:                 # every rank gets the same tokens
        for name in SAMPLES:
            np.testing.assert_array_equal(
                out["tokens_" + name], one_rank_tokens["worker_major", name])
            np.testing.assert_array_equal(
                out["tokens_" + name], one_rank_tokens["group_major", name])
        np.testing.assert_array_equal(out["tokens_survivor"],
                                      out["tokens_replicated"])


def test_gloo_top_k_ties_bitwise_equal_across_w(gloo_ranks):
    """Top-k draws on tied logits at W = 2, 4 and 8 equal the one-rank
    path's (W = 1) and the group-major path's bitwise: every rank selects
    in ``lax.top_k``'s order and the merge keeps it."""
    _, ranks = gloo_ranks
    coding = TCoding(k=K, s=S, e=E)
    n1 = coding.num_workers
    block = tied_block(n1)
    mask = torch.from_numpy(_mask(n1))
    masks = mask[None].expand(POOL, n1)
    dec = twm.survivor_decode_tail(coding, block, masks, mask,
                                   twm.WorkerShardConfig())
    top = torch.sort(dec, -1, descending=True).values[:, :50]
    assert (top[:, 1:] == top[:, :-1]).any(), "no tie in the top k"
    gen = torch.Generator().manual_seed(5)
    one_rank = np.stack([twm.survivor_decode_tail(
        coding, block, masks, mask, twm.WorkerShardConfig(),
        sample=TIED_SAMPLE, generator=gen).numpy()
        for _ in range(TIED_DRAWS)])
    alphas = torch.tensor(coding.alphas, dtype=torch.float32)
    betas = torch.tensor(coding.betas, dtype=torch.float32)
    rows = ops.fused_group_decode(block.transpose(0, 1), masks, alphas,
                                  betas).reshape(-1, 1024)
    gen = torch.Generator().manual_seed(5)
    group_major = np.stack([sample_tokens(rows, TIED_SAMPLE, gen).numpy()
                            for _ in range(TIED_DRAWS)])
    np.testing.assert_array_equal(one_rank, group_major)
    for out in ranks:
        np.testing.assert_array_equal(out["tied_tokens"], one_rank)


def test_gloo_greedy_tokens_equal_reference(gloo_ranks, reference_tokens):
    _, ranks = gloo_ranks
    for out in ranks:
        np.testing.assert_array_equal(out["tokens_greedy"], reference_tokens)


def test_gloo_survivor_moves_fewer_bytes_than_replicated(gloo_ranks):
    _, ranks = gloo_ranks
    for out in ranks:
        surv = out["bytes_survivor_total"]
        repl = out["bytes_replicated_total"]
        assert 0 < surv < repl, (surv, repl)
        assert (out["bytes_survivor_all-gather"]
                < out["bytes_replicated_all-gather"])
        assert out["bytes_survivor_reduce-scatter"] > 0
        assert "bytes_replicated_reduce-scatter" not in out


def test_gloo_vocab_not_divisible_takes_the_all_reduce(gloo_ranks):
    _, ranks = gloo_ranks
    coding = TCoding(k=K, s=S, e=E)
    n1 = coding.num_workers
    gen = torch.Generator().manual_seed(3)
    block = torch.randn((n1, POOL, 1001), generator=gen)
    mask = torch.from_numpy(_mask(n1))
    masks = mask[None].expand(POOL, n1)
    want = twm.survivor_decode_tail(coding, block, masks, mask,
                                    twm.WorkerShardConfig())
    for out in ranks:
        assert out["odd_vocab_ops"].tolist() == ["all-reduce", "total"]
        np.testing.assert_array_equal(out["odd_vocab_logits"], want.numpy())
        np.testing.assert_array_equal(out["odd_vocab_tokens"],
                                      want.argmax(-1).numpy())


def test_multihost_serve_on_gloo(tmp_path):
    """``launch.multihost --mode serve`` at W=2 on the CPU, 2 decode
    steps, 10 coded streams (K=7 S=3: 5 a rank)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    store = tmp_path / "store"
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost", "--mode",
           "serve", "--device", "cpu", "--reduced", "--coordinator",
           f"file://{store}", "--num-processes", "2", "--steps", "2",
           "--s", "3", "--pool-groups", "2", "--max-len", "32"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
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
        assert p.returncode == 0, logs[r][-3000:]
        assert f"process {r}: worker ranks [{r}] (streams/rank 5 of 10)" \
            in logs[r]
    assert "decode step 0: tokens" in logs[0]
    assert "2 decode calls" in logs[0]


_MULTIHOST = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch.launch import multihost

res = multihost.main(sys.argv[2:])
np.save(sys.argv[1], res["tokens"])
"""


def test_multihost_refuses_what_is_not_ported(tmp_path, capsys):
    """``--mode serve --multi-pod`` (the pod axis in serving) runs on two
    gloo processes, one worker and a pod axis of 2 (K=7 S=3: 10 streams x
    2 slots, 10 a rank), and every rank's tokens equal one process's;
    ``--mode train`` runs, here on one process."""
    from repro_torch.launch import multihost
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    serve = ["--mode", "serve", "--device", "cpu", "--reduced", "--dtype",
             "float32", "--steps", "2", "--s", "3", "--pool-groups", "2",
             "--max-len", "16"]
    tokens, logs = {}, {}
    for world, extra in ((1, []), (2, ["--multi-pod"])):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST,
             str(tmp_path / f"tokens{world}_{r}.npy"), "--coordinator",
             f"file://{tmp_path}/store{world}", "--num-processes",
             str(world), "--process-id", str(r)] + serve + extra, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs[world] = []
        try:
            for p in procs:
                logs[world].append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            assert p.returncode == 0, logs[world][r][-3000:]
        tokens[world] = [np.load(tmp_path / f"tokens{world}_{r}.npy")
                         for r in range(world)]
    for r in range(2):
        assert f"pod rank {r} of 2, pool streams 10 of 20" in logs[2][r]
    assert tokens[1][0].shape == (3, 2 * 7)
    for toks in tokens[2]:
        np.testing.assert_array_equal(toks, tokens[1][0])
    base = ["--coordinator", f"file://{tmp_path}/store", "--num-processes",
            "1", "--process-id", "0", "--device", "cpu"]
    res = multihost.main(base + ["--mode", "train", "--reduced", "--steps",
                                 "2", "--batch", "2", "--seq", "16"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert "step 0: loss" in capsys.readouterr().out
