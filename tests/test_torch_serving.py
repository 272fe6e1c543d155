"""Port parity of the whole slice: coded LLM serving rounds on qwen3-0.6b
``reduced()`` through ``repro_torch.serving`` against
``repro.serving`` (XLA path), plus the batch executor and the launcher.

Byzantine noise is drawn with ``jax.random.normal`` on the reference's
key and handed to the port as numpy.  Decoded fp32 logits agree within
rtol 1e-5, atol 1e-4; greedy tokens, ``located`` and ``votes`` exactly
(every attacked case uses sigma >= 10).
"""

import argparse

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import CodedLLMExecutor as JExecutor  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving.executor import (CodedLLMExecutor,  # noqa: E402
                                          RoundAttack)
from repro_torch.serving.sampling import (SampleConfig,  # noqa: E402
                                          sample_tokens, top_k_stable)

LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
PROMPT, STEPS = 8, 3
MAX_LEN = PROMPT + STEPS + 2


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _jit_steps(jc, coding):
    """The reference's steps jitted as its executor jits them."""
    prefill = jax.jit(
        lambda p, t, m, bm, br, live, lq: jcs.coded_prefill(
            jc, coding, p, {"tokens": t}, max_len=MAX_LEN, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True,
            live_mask=live, locate_quorum=lq))
    decode = jax.jit(
        lambda p, st, t, m, bm, br, live, lq: jcs.coded_decode_step(
            jc, coding, p, st, t, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True, live_mask=live,
            locate_quorum=lq))
    return prefill, decode


def _rounds(k, s, e):
    """Per-round (straggler mask, live mask, byzantine mask) of a run
    with stragglers every round, a persistent attacker at E > 0 and a
    live-mask narrowing to a smaller operating point in the last round."""
    coding = JCoding(k=k, s=s, e=e)
    n1 = coding.num_workers
    rng = np.random.RandomState(10 * k + e)
    byz = np.zeros(n1, np.float32)
    if e:
        byz[4] = 1.0
    out = []
    for r in range(1 + STEPS):
        m = np.ones(n1, np.float32)
        m[rng.choice([i for i in range(n1) if not byz[i]], s,
                     replace=False)] = 0.0
        live = np.ones(n1, np.float32)
        if r == STEPS:
            live[n1 - 1:] = 0.0       # one stream narrower, as a retune
        out.append((m, live, byz))
    return out


@pytest.mark.parametrize("k,s,e", [(2, 1, 0), (2, 1, 1)])
def test_coded_rounds_match_reference(model, k, s, e):
    jc, tc, jp, tp = model
    jcoding, tcoding = JCoding(k=k, s=s, e=e), TCoding(k=k, s=s, e=e)
    g = 2
    tokens = np.random.RandomState(3).randint(0, jc.vocab_size,
                                              (g * k, PROMPT))
    jprefill, jdecode = _jit_steps(jc, jcoding)
    key = jax.random.PRNGKey(7)
    jstate = tstate = None
    nxt = None
    with jops.force_kernel("xla"):
        for r, (m, live, byz) in enumerate(_rounds(k, s, e)):
            key, sub = jax.random.split(key)
            # the reference's own draw (coded_serving._corrupt_logits)
            noise = np.array(jax.random.normal(
                sub, (g, jcoding.num_workers, jc.vocab_size), jnp.float32))
            lq = jcoding.decode_quorum
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True, live_mask=torch.from_numpy(live),
                         locate_quorum=lq)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub,
                     jnp.asarray(live), jnp.asarray(lq, jnp.int32))
            if r == 0:
                jl, jstate, (jloc, jvotes) = jprefill(
                    jp, jnp.asarray(tokens), *jargs)
                tl, tstate, (tloc, tvotes) = tcs.coded_prefill(
                    tc, tcoding, tp, {"tokens": torch.from_numpy(tokens)},
                    MAX_LEN, **targs)
            else:
                jl, jstate, (jloc, jvotes) = jdecode(
                    jp, jstate, jnp.asarray(nxt)[:, None], *jargs)
                tl, tstate, (tloc, tvotes) = tcs.coded_decode_step(
                    tc, tcoding, tp, tstate, torch.tensor(nxt)[:, None],
                    **targs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
            np.testing.assert_array_equal(tvotes.numpy(), np.asarray(jvotes))
            if e:
                # the attacker is located in every group, every round
                assert tloc.numpy()[:, 4].all()
    assert tstate.pos == PROMPT + STEPS


def test_colluding_noise_broadcasts_over_the_group():
    coding = TCoding(k=2, s=1, e=1)
    n1 = coding.num_workers
    logits = torch.zeros(2 * n1, 6)
    byz = torch.zeros(n1)
    byz[[1, 3]] = 1.0
    noise = torch.arange(12, dtype=torch.float32).reshape(2, 1, 6)
    out = tcs._corrupt_logits(coding, logits, byz, noise, 2.0)
    out = out.reshape(2, n1, 6)
    torch.testing.assert_close(out[:, 1], out[:, 3], rtol=0, atol=0)
    torch.testing.assert_close(out[:, 1], 2.0 * noise[:, 0])
    assert not out[:, [0, 2]].any()


def _jax_executor_tokens(jc, jp, coding, prompts, masks, point=None):
    ex = JExecutor(jc, coding, jp, steps=STEPS, max_len=MAX_LEN)
    with jops.force_kernel("xla"):
        h = ex.dispatch(prompts, scheme=point)
        for r in range(STEPS):
            h, _ = ex.step(h, r, masks[r])
        toks, _ = ex.decode(h, masks[STEPS])
    return toks


@pytest.mark.parametrize("narrow", [False, True])
def test_executor_tokens_match_reference(model, narrow):
    """Greedy (B, steps+1) token matrices, with stragglers; ``narrow``
    dispatches at a smaller operating point of the same K than the
    executor's (the masked max-width re-planning)."""
    jc, tc, jp, tp = model
    wide = (2, 1, 1)
    point = (2, 1, 0) if narrow else wide
    width = JCoding(*point).num_workers
    prompts = np.random.RandomState(5).randint(0, jc.vocab_size,
                                               (4, PROMPT)).astype(np.int32)
    rng = np.random.RandomState(6)
    masks = []
    for _ in range(1 + STEPS):
        m = np.ones(width, np.float32)
        m[rng.randint(width)] = 0.0
        masks.append(m)
    jpoint = JCoding(*point) if narrow else None
    want = _jax_executor_tokens(jc, jp, JCoding(*wide), prompts, masks,
                                point=jpoint)
    ex = CodedLLMExecutor(tc, TCoding(*wide), tp, steps=STEPS,
                          max_len=MAX_LEN)
    h = ex.dispatch(prompts, scheme=TCoding(*point) if narrow else None)
    for r in range(STEPS):
        h, _ = ex.step(h, r, masks[r])
    got, report = ex.decode(h, masks[STEPS])
    assert got.shape == (4, 1 + STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert report.located.shape == (2, width)


def test_executor_locates_a_persistent_attacker_and_keeps_order(model):
    _, tc, _, tp = model
    coding = TCoding(k=2, s=1, e=1)
    ex = CodedLLMExecutor(tc, coding, tp, steps=2, max_len=MAX_LEN)
    h = ex.dispatch(np.zeros((4, PROMPT), np.int32))
    byz = np.zeros(coding.num_workers, np.float32)
    byz[2] = 1.0
    attack = RoundAttack(mask=byz, sigma=10.0)
    mask = np.ones(coding.num_workers, np.float32)
    h, rep = ex.step(h, 0, mask, attack)
    assert rep.detected.tolist() == (byz > 0).tolist()
    with pytest.raises(RuntimeError, match="round accounting"):
        ex.step(h, 0, mask, attack)
    with pytest.raises(ValueError, match="operating point"):
        ex.dispatch(np.zeros((4, PROMPT), np.int32), scheme=TCoding(k=3))


def test_serve_runs_the_batch_path_on_cpu():
    res = serve.run_fixed_masks(reduced=True, requests=8, k=4, s=1, e=1, prompt_len=6,
                    steps=2, byz_sigma=10.0, seed=1, device="cpu")
    assert res["tokens"].shape == (8, 3)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()
    assert res["precision"] == 1.0 and res["recall"] == 1.0
    assert len(res["round_ms"]) == 3 and res["tokens_per_s"] > 0


def test_serve_refuses_what_is_not_ported():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(reduced=True)
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--attack", "byzantine"])
    # --scheme parm, refused until the schemes were ported, now serves
    res = serve.main(["--reduced", "--device", "cpu", "--scheme", "parm",
                      "--requests", "8"])
    assert res["tokens"].shape == (8, 1)


@pytest.mark.parametrize("flag", [["--adaptive"], ["--quarantine"],
                                  ["--traffic", "diurnal"]],
                         ids=["adaptive", "quarantine", "traffic"])
def test_serve_runs_the_batch_scheduler_flags(flag, capsys):
    """The flags the batch path once refused run on the event clock of
    the batch scheduler."""
    res = serve.main(["--reduced", "--device", "cpu", "--requests", "8",
                      "--k", "4", "--e", "1", "--byz-sigma", "10",
                      "--steps", "2", *flag])
    assert res["tokens"].shape == (8, 3)
    assert [ev[0] for ev in res["trace"]].count("complete") == len(
        res["batches"])
    out = capsys.readouterr().out
    if flag == ["--adaptive"]:
        assert res["decisions"][0] == (11, 1, 6, 0)
        assert "retune @round 0" in out
    if flag == ["--traffic", "diurnal"]:
        assert "(diurnal)" in out


def test_sampling_greedy_and_top_k():
    logits = torch.tensor([[0.0, 3.0, 3.0, -1.0], [5.0, 1.0, 2.0, 0.0]])
    np.testing.assert_array_equal(
        sample_tokens(logits, SampleConfig()).numpy(), [1, 0])
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(logits.expand(64, 2, 4), SampleConfig(top_k=2),
                          gen)
    assert draws.dtype == torch.int32 and draws.shape == (64, 2)
    assert set(draws[:, 0].tolist()) <= {1, 2}
    assert set(draws[:, 1].tolist()) <= {0, 2}
    with pytest.raises(ValueError, match="generator"):
        sample_tokens(logits, SampleConfig(top_k=2))


def _tied_logits(kind: str) -> np.ndarray:
    """(16, 4096) logits with many ties near the top: randn rounded to
    bf16, or fp32 rounded to 3 decimals."""
    x = np.random.RandomState(11).randn(16, 4096).astype(np.float32) * 2
    if kind == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return np.round(x, 3)


@pytest.mark.parametrize("kind,k", [("bf16", 50), ("fp32_3_decimals", 50),
                                    ("fp32_3_decimals", 1000)])
def test_top_k_stable_matches_lax_top_k(kind, k):
    """``top_k_stable`` selects in ``lax.top_k``'s order: value
    descending, the lower index first among equal values."""
    x = _tied_logits(kind)
    vals, idx = top_k_stable(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    # the case has ties inside the top k
    assert (np.diff(vals.numpy(), axis=-1) == 0).any()


def test_top_k_sampling_on_ties_draws_the_reference_candidates():
    """On tied bf16 logits, the top-k sampler's candidates (and so each
    draw's token) follow ``lax.top_k``'s order: a draw's choice index
    maps to the same token as in the reference."""
    x = torch.from_numpy(_tied_logits("bf16"))
    cfg = SampleConfig(top_k=50, temperature=0.7)
    got = sample_tokens(x, cfg, torch.Generator().manual_seed(2))
    _, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 50)
    probs = torch.softmax(top_k_stable(x, 50)[0] / 0.7, dim=-1)
    choice = torch.multinomial(probs, 1,
                               generator=torch.Generator().manual_seed(2))
    want = np.take_along_axis(np.asarray(ji), choice.numpy(), -1)[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_takes_the_reference_flags(continuous, capsys):
    """The launcher parses and runs the reference's flags: --top-k,
    --temperature, --attack-placement, --deadline-ms, and on the event
    clock of either path --probation-ms, --churn-up-ms, --churn-down-ms
    and --traffic diurnal; the batch path also --groups and --slo-ms."""
    argv = ["--reduced", "--device", "cpu", "--k", "4", "--e", "1",
            "--byz-sigma", "10", "--top-k", "5", "--temperature", "0.7",
            "--attack-placement", "worst_case", "--seed", "3"]
    if continuous:
        argv += ["--continuous", "--requests", "16", "--pool-groups", "2",
                 "--steps", "4", "--quarantine", "--probation-ms", "20",
                 "--churn", "--churn-up-ms", "500", "--churn-down-ms", "50",
                 "--traffic", "diurnal", "--rate", "400", "--deadline-ms",
                 "3"]
        res = serve.main(argv)
        assert sorted(res["results"]) == list(range(16))
        for uid, toks in res["results"].items():
            assert len(toks) == res["budgets"][uid]
        assert "(diurnal)" in capsys.readouterr().out
    else:
        res = serve.main(argv + ["--requests", "8", "--steps", "3",
                                 "--groups", "1", "--slo-ms", "40",
                                 "--quarantine", "--probation-ms", "20",
                                 "--churn", "--churn-up-ms", "500",
                                 "--churn-down-ms", "50", "--traffic",
                                 "diurnal", "--rate", "400",
                                 "--deadline-ms", "3"])
        assert res["tokens"].shape == (8, 4)
        assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()
        # --groups 1: every batch is one group of K (padded if flushed)
        assert all(len(b.plan.requests) == 4 for b in res["batches"])
        assert res["metrics"].slo_ms == 40.0
        assert "(diurnal)" in capsys.readouterr().out
    for bad in (["--flush-deadline-ms", "3"],):
        with pytest.raises(SystemExit):
            serve.main(["--reduced", "--device", "cpu", *bad])


def _parser_defaults(main, monkeypatch):
    """The defaults of the parser that ``main`` builds, read without
    running it."""
    got = {}

    def defaults_only(self, args=None, namespace=None):
        got.update(vars(self.parse_known_args([])[0]))
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", defaults_only)
        with pytest.raises(SystemExit):
            main()
    return got


def test_serve_defaults_match_the_reference(monkeypatch):
    """Each flag shared with the reference's launcher has its name and
    default."""
    from repro.launch import serve as jserve
    port = _parser_defaults(serve.main, monkeypatch)
    ref_ = _parser_defaults(jserve.main, monkeypatch)
    for flag in ("top_k", "temperature", "attack_placement", "deadline_ms",
                 "probation_ms", "churn_up_ms", "churn_down_ms", "traffic",
                 "rate", "byz_sigma", "attack", "attack_rate", "continuous",
                 "pool_groups", "quarantine", "churn", "groups", "slo_ms",
                 "adaptive"):
        assert port[flag] == ref_[flag], flag
