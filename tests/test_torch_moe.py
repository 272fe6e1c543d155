"""Port parity of the MoE slice: ``repro_torch.models.moe`` and the "M"
runs of qwen3-moe-30b-a3b and grok-1-314b in their ``reduced()`` sizes
(2 layers, d_model 256, 4 experts top-2, groups of 64 tokens) against
``repro.models`` on the reference's XLA path, on the reference's own
parameters (``params_from_jax``) and the same numpy inputs.

Tolerances: router probabilities within rtol 1e-5, atol 1e-6 (the same
fp32 product and softmax, summed in another order: the router logits
differ by a few ulps); block outputs within rtol 1e-5, atol 1e-5;
logits and losses within ``LOGITS_TOL`` (rtol 1e-5, atol 1e-4: another
summation order in every product); the aux statistics within rtol 1e-5,
atol 1e-6 (the reference's dropped fraction is 1 - sum / count in fp32,
so an exact 0 can come out as -1e-7).  Expert indices, greedy tokens and
locator verdicts exactly.

Routing is discrete: where the k-th and (k+1)-th router logits of a
token sit closer than the two packages' rounding apart, either may pick
the other expert.  So every test that holds routes prints the smallest
top-k margin of its inputs (``pytest -s``) and asserts it is above
``MARGIN``, ten times the packages' largest router-logit difference
(``LOGIT_GAP``, which the router test holds); the routes are then held
exactly.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import predict_fn as j_predict_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
PROB_TOL = dict(rtol=1e-5, atol=1e-6)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
AUX_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_GAP = 1e-5
MARGIN = 10 * LOGIT_GAP
PROMPT, STEPS = 8, 3
MAX_LEN = PROMPT + STEPS + 2


@pytest.fixture(scope="module")
def models():
    """(reference config, port config, reference params, port params) of
    each reduced architecture, built once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]

    return get


def _layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def topk_margin(logits: np.ndarray, k: int) -> float:
    """The smallest gap between the k-th and (k+1)-th largest router
    logit over the tokens (inf when every expert is picked)."""
    if logits.shape[-1] <= k:
        return float("inf")
    top = -np.sort(-logits.reshape(-1, logits.shape[-1]), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.fixture
def margins(monkeypatch):
    """Every router call of the port records its top-k margin."""
    seen = []
    real = tmoe.router_logits

    def record(p, x):
        out = real(p, x)
        seen.append(out.detach().numpy())
        return out

    monkeypatch.setattr(tmoe, "router_logits", record)

    def check(cfg, where):
        least = min(topk_margin(l, cfg.experts_per_token) for l in seen)
        print(f"{where}: {len(seen)} router calls, smallest top-"
              f"{cfg.experts_per_token} margin {least:.3g}")
        assert least > MARGIN
        return least

    return check


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_and_counts_match_reference(arch):
    for jc, tc in ((jconfigs.get_config(arch), configs.get_config(arch)),
                   (jconfigs.get_reduced(arch), configs.get_reduced(arch))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert set(tc.layer_pattern) == {"M"}
    if arch == "qwen3-moe-30b-a3b":
        cfg = configs.get_config(arch)
        assert cfg.param_count() == 30_531_911_680
        assert cfg.active_param_count() == 3_352_821_760


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_convert_leaf_for_leaf(dtype):
    """The reference's tree converts into the port's own ``init_params``
    structure, shapes and dtypes; the router stays fp32 in a bf16
    model, as ``dense_init(..., jnp.float32)`` keeps it."""
    jc = jconfigs.get_reduced("qwen3-moe-30b-a3b").with_updates(
        param_dtype=dtype)
    tc = configs.get_reduced("qwen3-moe-30b-a3b").with_updates(
        param_dtype=dtype)
    conv = params_from_jax(
        jax.tree.map(np.asarray, j_init_params(jc, jax.random.PRNGKey(1))),
        device="cpu")
    own = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def signature(tree):
        if isinstance(tree, dict):
            return {k: signature(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [signature(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert signature(conv) == signature(own)
    run = own["blocks"]["runs"][0]["moe"]
    assert run["router"].dtype == torch.float32
    assert run["w_gate"].dtype == getattr(torch, dtype)
    assert tuple(run["w_out"].shape) == (2, 4, 128, 256)


# ------------------------------------------------------------- router

@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_reference(arch, models):
    """Probabilities, indices (``lax.top_k``'s order) and the full
    softmax, on inputs whose smallest top-k margin is printed and above
    ``MARGIN``; renormalised (qwen3-moe) and not (grok)."""
    jc, tc, jp, tp = models(arch)
    jl, tl = jp["blocks"]["runs"][0]["moe"], _layer(
        tp["blocks"]["runs"][0])["moe"]
    jl = jax.tree.map(lambda a: a[0], jl)
    x = np.random.RandomState(20).randn(3, 40, tc.d_model).astype(
        np.float32)
    logits = np.asarray(x @ np.asarray(jl["router"]))
    least = topk_margin(logits, tc.experts_per_token)
    print(f"{arch}: smallest top-{tc.experts_per_token} margin {least:.3g}")
    assert least > MARGIN
    gap = np.abs(tmoe.router_logits(tl, torch.from_numpy(x)).numpy()
                 - np.asarray(jnp.asarray(x) @ jl["router"])).max()
    assert gap < LOGIT_GAP
    jtop_p, jtop_i, jfull = jmoe.router_probs(jc, jl, jnp.asarray(x))
    ttop_p, ttop_i, tfull = tmoe.router_probs(tc, tl, torch.from_numpy(x))
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(ttop_p.numpy(), np.asarray(jtop_p),
                               **PROB_TOL)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **PROB_TOL)
    assert ttop_p.dtype == tfull.dtype == torch.float32
    sums = ttop_p.sum(-1).numpy()
    if tc.router_norm_topk:
        np.testing.assert_allclose(sums, 1.0, rtol=1e-6)
    else:
        assert (sums < 1.0).all()


def test_router_ties_take_the_lower_index_first():
    """Equal router probabilities: ``lax.top_k``'s order (lower expert
    first), which ``torch.topk`` does not promise (ROADMAP C1)."""
    tc = configs.get_reduced("qwen3-moe-30b-a3b").with_updates(
        num_experts=8, experts_per_token=3)
    jc = jconfigs.get_reduced("qwen3-moe-30b-a3b").with_updates(
        num_experts=8, experts_per_token=3)
    col = np.random.RandomState(21).randn(tc.d_model, 1)
    router = np.repeat(col, 8, axis=1).astype(np.float32)
    router[:, [1, 6]] *= 0.5                   # two experts below the tie
    x = np.random.RandomState(22).randn(2, 5, tc.d_model).astype(np.float32)
    _, jtop_i, _ = jmoe.router_probs(jc, {"router": jnp.asarray(router)},
                                     jnp.asarray(x))
    _, ttop_i, _ = tmoe.router_probs(tc, {"router": torch.from_numpy(router)},
                                     torch.from_numpy(x))
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(jtop_i))


@pytest.mark.parametrize("group_size", [1, 2, 3, 4, 7, 16, 63, 64, 96, 1024,
                                        2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch, group_size):
    for factor in (0.5, 1.25, 4.0):
        jc = jconfigs.get_config(arch).with_updates(capacity_factor=factor)
        tc = configs.get_config(arch).with_updates(capacity_factor=factor)
        assert tmoe._capacity(tc, group_size) == jmoe._capacity(
            jc, group_size)
    # the card's serving shapes (qwen3-moe): prefill groups of 1024 and
    # 2048 tokens hold 80 and 160 tokens an expert
    if arch == "qwen3-moe-30b-a3b" and group_size in (1024, 2048):
        cap = tmoe._capacity(configs.get_config(arch), group_size)
        assert cap == group_size * 8 // 128 * 5 // 4


@pytest.mark.parametrize("tokens,want", [(11264, 1024), (9216, 1024),
                                         (18432, 2048), (44, 44), (72, 72),
                                         (144, 144), (65, 1), (96, 32)])
def test_group_size_halves_until_it_divides(tokens, want):
    """The reference's loop (``moe_block``, ``:72``) at the card's
    prefill and decode token counts and at reduced sizes."""
    size = 64 if tokens in (65, 96) else 2048
    cfg = configs.get_config("qwen3-moe-30b-a3b").with_updates(
        moe_group_size=size)
    assert tmoe.group_size(cfg, tokens) == want


# ------------------------------------------------------------- block

@pytest.mark.parametrize("shape", [(2, 32), (3, 32), (5, 13)],
                         ids=["one_group", "96_tokens", "65_tokens"])
@pytest.mark.parametrize("factor", [0.5, 4.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, factor, shape, models):
    """``y`` and the three aux values, at a capacity factor that drops
    tokens and one that drops none, at token counts that are and are not
    a multiple of the group size (96 tokens: groups of 32; 65: of 1)."""
    jc, tc, jp, tp = models(arch)
    jc = jc.with_updates(capacity_factor=factor)
    tc = tc.with_updates(capacity_factor=factor)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["runs"][0]["moe"])
    tl = _layer(tp["blocks"]["runs"][0])["moe"]
    x = np.random.RandomState(sum(shape)).randn(*shape, tc.d_model).astype(
        np.float32)
    logits = x @ np.asarray(jl["router"])
    least = topk_margin(logits, tc.experts_per_token)
    print(f"{arch} factor {factor} {shape}: smallest margin {least:.3g}")
    assert least > MARGIN
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(jc, p, x))(
        jl, jnp.asarray(x))
    ty, taux = tmoe.moe_block(tc, tl, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK_TOL)
    assert sorted(taux) == sorted(jaux)
    for name, val in taux.items():
        assert val.dtype == torch.float32 and val.shape == ()
        np.testing.assert_allclose(float(val), float(jaux[name]), **AUX_TOL)
    dropped = float(taux["dropped_fraction"])
    if factor < 1.0 and tmoe.group_size(tc, x.shape[0] * x.shape[1]) > 1:
        assert dropped > 0.05
    else:          # a one-token group fits any capacity (at least 4)
        assert abs(dropped) < 1e-6


def test_moe_block_in_bf16_matches_reference(models):
    """A bf16 block on the reference's weights cast to bf16 (the router
    stays fp32): the router reads the bf16 input in fp32, so the routes
    are the reference's (margin printed); dispatch and combine enter the
    einsums in bf16 and ``y`` comes back in bf16 within 2 bf16 ulps of
    the reference's at its largest magnitude."""
    jc, tc, jp, _ = models("qwen3-moe-30b-a3b")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["runs"][0]["moe"])
    jl = {k: v if k == "router" else v.astype(jnp.bfloat16)
          for k, v in jl.items()}
    tl = params_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    assert tl["router"].dtype == torch.float32
    assert tl["w_in"].dtype == torch.bfloat16
    x = np.random.RandomState(23).randn(2, 48, tc.d_model).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    least = topk_margin(np.asarray(xb.astype(jnp.float32) @ jl["router"]),
                        tc.experts_per_token)
    print(f"bf16 block: smallest margin {least:.3g}")
    assert least > MARGIN
    jy, jaux = jmoe.moe_block(jc, jl, xb)
    ty, taux = tmoe.moe_block(
        tc, tl, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    err = np.abs(ty.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(want).max()
    for name, val in taux.items():
        assert val.dtype == torch.float32
        np.testing.assert_allclose(float(val), float(jaux[name]), **AUX_TOL)


# ------------------------------------------------------------- model

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_caches_match_reference(arch, models, margins):
    jc, tc, jp, tp = models(arch)
    b, s, steps = 3, 10, 3
    max_len = s + steps + 1
    tokens = np.random.RandomState(1).randint(0, 512, (b, s))
    with jops.force_kernel("xla"):
        jl, jcache = j_prefill(jc, jp, {"tokens": jnp.asarray(tokens)},
                               j_init_caches(jc, b, max_len))
        tl, tcache = tmodel.prefill(
            tc, tp, {"tokens": torch.from_numpy(tokens)},
            tmodel.init_caches(tc, b, max_len, torch.float32, "cpu"))
        for step in range(steps + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1))
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            if step == steps:
                break
            jl, jcache = j_decode_step(jc, jp, jcache,
                                       {"tokens": jnp.asarray(nxt)[:, None]},
                                       jnp.asarray(s + step, jnp.int32))
            tl, tcache = tmodel.decode_step(
                tc, tp, tcache, {"tokens": torch.tensor(nxt)[:, None]},
                s + step)
    assert len(tcache) == len(jcache) == 1
    for name in ("k", "v"):
        assert tcache[0][name].shape == jcache[0][name].shape
        np.testing.assert_allclose(tcache[0][name].numpy(),
                                   np.asarray(jcache[0][name]), **LOGITS_TOL)
    margins(tc, f"{arch} prefill and decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_predict_and_loss_match_reference(arch, models, margins):
    """``forward`` (logits and the aux summed over the layers),
    ``predict_fn`` on embeddings, and ``lm_loss`` without targets, with
    targets and with a loss mask: its total carries
    ``aux_weight * (load_balance + 0.1 * z)``."""
    jc, tc, jp, tp = models(arch)
    b, s, t = 2, 17, 6
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, 512, (b, s))
    targets = rng.randint(0, 512, (b, t))
    mask = (rng.rand(b, t) < 0.6).astype(np.float32)
    emb = rng.randn(b, s, tc.d_model).astype(np.float32)
    batches = {"tokens": {"tokens": tokens},
               "targets": {"tokens": tokens, "targets": targets},
               "loss_mask": {"tokens": tokens, "targets": targets,
                             "loss_mask": mask}}
    with jops.force_kernel("xla"):
        jl, jaux = j_forward(jc, jp, {"tokens": jnp.asarray(tokens)})
        jpred = j_predict_fn(jc, jp)(jnp.asarray(emb))
        jloss = {k: j_lm_loss(jc, jp, jax.tree.map(jnp.asarray, v))
                 for k, v in batches.items()}
    tl, taux = tmodel.forward(tc, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    assert sorted(taux) == sorted(jaux)
    for key, val in taux.items():
        np.testing.assert_allclose(float(val), float(jaux[key]), **AUX_TOL)
    assert float(taux["load_balance_loss"]) > 1.0    # 2 layers, >= 1 each
    np.testing.assert_allclose(
        tmodel.predict_fn(tc, tp)(torch.from_numpy(emb)).numpy(),
        np.asarray(jpred), **LOGITS_TOL)
    for key, batch in batches.items():
        total, metrics = tmodel.lm_loss(
            tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        jtotal, jmetrics = jloss[key]
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        for name, val in metrics.items():
            np.testing.assert_allclose(float(val), float(jmetrics[name]),
                                       rtol=1e-5, atol=1e-6)
        # the aux terms are in the total
        extra = 0.01 * (float(metrics["load_balance_loss"])
                        + 0.1 * float(taux["router_z_loss"]))
        np.testing.assert_allclose(float(total) - float(metrics["ce_loss"]),
                                   extra, rtol=1e-4)
    margins(tc, f"{arch} forward")


# ------------------------------------------------------------- coded rounds

def _jit_steps(jc, coding):
    prefill = jax.jit(
        lambda p, t, m, bm, br, lq: jcs.coded_prefill(
            jc, coding, p, {"tokens": t}, max_len=MAX_LEN, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True,
            locate_quorum=lq))
    decode = jax.jit(
        lambda p, st, t, m, bm, br, lq: jcs.coded_decode_step(
            jc, coding, p, st, t, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True, locate_quorum=lq))
    return prefill, decode


@pytest.mark.parametrize("arch", ARCHS)
def test_coded_rounds_match_reference(arch, models, margins):
    """One E=1 coded run (K=2, 2 groups, 8-token prompts, 3 decode
    steps) against the reference's jitted steps: a straggler each round,
    a persistent attacker, the reference's noise; logits, greedy tokens
    and verdicts equal, each vote tally within one pick (ROADMAP C); the
    coded streams' caches at the end."""
    jc, tc, jp, tp = models(arch)
    k, g = 2, 2
    jcoding, tcoding = JCoding(k=k, s=1, e=1), TCoding(k=k, s=1, e=1)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(30)
    tokens = rng.randint(0, jc.vocab_size, (g * k, PROMPT))
    byz = np.zeros(n1, np.float32)
    byz[4] = 1.0
    jprefill, jdecode = _jit_steps(jc, jcoding)
    key = jax.random.PRNGKey(11)
    lq = jcoding.decode_quorum
    jstate = tstate = nxt = None
    with jops.force_kernel("xla"):
        for r in range(1 + STEPS):
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (g, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True, locate_quorum=lq)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub,
                     jnp.asarray(lq, jnp.int32))
            if r == 0:
                jl, jstate, jrep = jprefill(jp, jnp.asarray(tokens), *jargs)
                tl, tstate, trep = tcs.coded_prefill(
                    tc, tcoding, tp, {"tokens": torch.from_numpy(tokens)},
                    MAX_LEN, **targs)
            else:
                jl, jstate, jrep = jdecode(jp, jstate,
                                           jnp.asarray(nxt)[:, None], *jargs)
                tl, tstate, trep = tcs.coded_decode_step(
                    tc, tcoding, tp, tstate, torch.tensor(nxt)[:, None],
                    **targs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            (tloc, tvotes), (jloc, jvotes) = trep, jrep
            np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
            assert np.abs(tvotes.numpy() - np.asarray(jvotes)).max() <= 1
            assert tloc.numpy()[:, 4].all()
    for tr, jr in zip(tstate.caches, jstate.caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(tr[name].numpy(), np.asarray(jr[name]),
                                       **LOGITS_TOL)
    margins(tc, f"{arch} coded rounds")


POOL = 2


def test_pool_steps_match_reference_with_every_slot_live(models, margins):
    """The slot pool on qwen3-moe at E=1: both group slots admitted in
    the first call, then decoding together.  A free slot's stream enters
    the router and competes for expert capacity in both packages, and
    its contents differ between them (ROADMAP C), so MoE pool parity is
    held where every slot is live."""
    jc, tc, jp, tp = models("qwen3-moe-30b-a3b")
    k = 2
    jcoding, tcoding = JCoding(k=k, s=1, e=1), TCoding(k=k, s=1, e=1)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(40)
    byz = np.zeros(n1, np.float32)
    byz[4] = 1.0
    jprefill = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_prefill(
            jc, jcoding, p, st, {"tokens": t}, MAX_LEN, a, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True))
    jdecode = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_decode_step(
            jc, jcoding, p, st, t, a, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True))
    jstate = jcs.init_pool_state(jc, jcoding, POOL, MAX_LEN)
    tstate = tcs.init_pool_state(tc, tcoding, POOL, MAX_LEN, "cpu")
    fresh = tcs.init_caches(tc, POOL * n1, MAX_LEN, torch.float32, "cpu")
    prompts = rng.randint(0, jc.vocab_size, (POOL * k, PROMPT)).astype(
        np.int32)
    admit = np.ones(POOL, np.float32)
    key = jax.random.PRNGKey(13)
    nxt = None
    with jops.force_kernel("xla"):
        for r in range(1 + STEPS):
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (POOL, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True)
            jargs = (jnp.asarray(admit), jnp.asarray(m), jnp.asarray(byz),
                     sub)
            if r == 0:
                jl, jstate, jrep = jprefill(jp, jstate, jnp.asarray(prompts),
                                            *jargs)
                tl, tstate, trep = tcs.coded_pool_prefill(
                    tc, tcoding, tp, tstate,
                    {"tokens": torch.from_numpy(prompts)}, admit, fresh,
                    **targs)
            else:
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt),
                                           *jargs)
                tl, tstate, trep = tcs.coded_pool_decode_step(
                    tc, tcoding, tp, tstate, torch.from_numpy(nxt), admit,
                    **targs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), toks)
            np.testing.assert_array_equal(trep[0].numpy(),
                                          np.asarray(jrep[0]))
            assert trep[0].numpy()[:, 4].all()
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(jstate.pos))
            nxt = toks[:, None]
    margins(tc, "qwen3-moe pool")


def test_check_ported_admits_moe_blocks():
    transformer.check_ported(configs.get_config("qwen3-moe-30b-a3b"))
    transformer.check_ported(configs.get_config("grok-1-314b"))
