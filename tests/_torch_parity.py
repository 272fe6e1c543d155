"""Helpers shared by the port's scheduler and controller parity tests.

``share_noise`` hands the reference adversary's noise to the port: each
side's adversary is drawn once per round, so the port's k-th attack
draws ``jax.random.normal`` on the reference's k-th key.  The reference
run must come first.  ``near_tie_walk`` holds two runs' verdicts
together and explains each that differs by the exact reading of its
vote columns (``repro_torch.core.error_locator.exact_tally``; see ROADMAP
C, "Verdicts at the bare K+2E quorum are near-ties").
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.serving import failures as jfail
from repro_torch.core import error_locator as tel
from repro_torch.serving import failures as tfail

# the vote columns are coded logits: the logits' tolerance
COLUMN_TOL = dict(rtol=1e-5, atol=1e-4)

_J_NEXT = jfail.Adversary.next_round
_T_NEXT = tfail.Adversary.next_round


def share_noise(monkeypatch):
    """Record the reference's round keys and the port's round seeds, and
    make the port's k-th attack draw the reference's k-th noise."""
    keys, seeds = [], []

    def jnext(self):
        attack = _J_NEXT(self)
        keys.append(attack.key)
        return attack

    def tnext(self):
        attack = _T_NEXT(self)
        seeds.append(attack.seed)
        return attack

    def noise(self, groups, workers, vocab, device):
        key = keys[seeds.index(self.seed)]
        shape = (groups, 1 if self.collude else workers, vocab)
        return torch.from_numpy(np.array(jax.random.normal(
            key, shape, jnp.float32))).to(device)

    monkeypatch.setattr(jfail.Adversary, "next_round", jnext)
    monkeypatch.setattr(tfail.Adversary, "next_round", tnext)
    monkeypatch.setattr(tfail.RoundAttack, "noise", noise)


def capture_columns(monkeypatch, jmodule, tmodule):
    """Record the vote columns (vals, avail) of every locate call each
    side makes through ``module.locate_groups``: the reference's from
    inside its compiled steps (an ordered ``jax.debug.callback``; the
    tracing caches are cleared so that every step is traced anew), the
    port's as it calls.  Returns (reference list, port list)."""
    jcols, tcols = [], []
    jreal, treal = jmodule.locate_groups, tmodule.locate_groups

    def keep(vals, avail):
        jcols.append((np.array(vals), np.array(avail)))

    def jlocate(betas, vals, avail, **kw):
        jax.debug.callback(keep, vals, avail, ordered=True)
        return jreal(betas, vals, avail, **kw)

    def tlocate(betas, vals, avail, **kw):
        tcols.append((vals.clone(), avail.clone()))
        return treal(betas, vals, avail, **kw)

    monkeypatch.setattr(jmodule, "locate_groups", jlocate)
    monkeypatch.setattr(tmodule, "locate_groups", tlocate)
    jax.clear_caches()
    return jcols, tcols


def locate_rounds(sched):
    """(batch, round, survivors, located or None) of every round a
    ``CodedScheduler`` ran, in the order it ran them (the trace's)."""
    out = []
    for ev in sched.trace:
        if ev[0] == "round":
            report = sched.batches[ev[1]].round_reports[ev[2]]
            out.append((ev[1], ev[2], ev[4], None if report is None
                        else np.asarray(report.located)))
    return out


def record_pool_calls(monkeypatch, executor_cls, log):
    """Log every slot-pool call's (kind, straggler mask, group mask,
    located) in the order the calls ran."""
    for kind in ("prefill", "decode"):
        real = getattr(executor_cls, kind)

        def call(self, state, tokens, group_mask, mask, *a, _real=real,
                 _kind=kind, **kw):
            out = _real(self, state, tokens, group_mask, mask, *a, **kw)
            log.append((_kind, np.asarray(mask).tolist(),
                        np.asarray(group_mask).tolist(),
                        np.asarray(out[2].located)))
            return out

        monkeypatch.setattr(executor_cls, kind, call)


def pool_call_rounds(trace):
    """The pool round of each slot-pool call, in call order: a round
    prefills its admissions, then decodes its actives."""
    out = []
    for ev in trace:
        if ev[0] == "round":
            out += [ev[1]] * (bool(ev[3]) + bool(ev[4]))
    return out


def near_tie_walk(coding, jrounds, trounds, jcolumns, tcolumns,
                  per_batch=False):
    """Walk two runs' rounds (or calls: tuples whose last item is the
    located verdicts) in order up to the first whose keys (worker masks)
    differ.  ``jcolumns``, ``tcolumns``: one (vals, avail) per locate call
    of each side (``capture_columns``).  On every locate call whose inputs
    are still the same on both sides (before the first disputed verdict,
    or with ``per_batch`` before the first of that call's batch, the
    key's first item) the port's vote columns must match the reference's
    within ``COLUMN_TOL`` and its availability exactly.  Where a verdict
    differs, the port's must be explained by the exact reading of its own
    columns (``ExactTally.explains``: the fp64 verdict, or a near tie).
    Prints each disputed verdict.  Returns (index of the first round
    whose masks differ, or None; indices of the rounds with a disputed
    verdict)."""
    jcols, tcols = iter(jcolumns), iter(tcolumns)
    ties, tainted = [], set()
    for i, (jr, tr) in enumerate(zip(jrounds, trounds)):
        if jr[:-1] != tr[:-1]:
            return i, ties
        assert (jr[-1] is None) == (tr[-1] is None), i
        if tr[-1] is None:
            continue
        (jv, ja), (tv, ta) = next(jcols), next(tcols)
        batch = tr[0] if per_batch else None
        if batch not in tainted:
            np.testing.assert_array_equal(ta.numpy(), ja)
            np.testing.assert_allclose(tv.numpy(), jv, **COLUMN_TOL,
                                       err_msg=f"vote columns of call {i}")
        disputed = np.flatnonzero((jr[-1] != tr[-1]).any(0))
        if not disputed.size:
            continue
        reading = tel.exact_tally(coding, tv, ta)
        for w in disputed:
            port = bool(tr[-1][:, w].any())
            print(f"call {i} ({tr[0]}, {tr[1]}): worker {w} "
                  f"located by the port {port}, exact "
                  f"{w in reading.located}: tally {reading.tally[w]} vs "
                  f"threshold {reading.threshold:g}, fp32 moves "
                  f"{reading.moved}/{tv.shape[0] * tv.shape[2]} picks")
            assert reading.explains(w, port), (i, w, reading)
        ties.append(i)
        tainted.add(batch)
    assert len(jrounds) == len(trounds)
    return None, ties


def assert_tokens_before_disputes(jsch, tsch, rounds, ties, upto=None):
    """Each batch's tokens agree in the columns before its first disputed
    round, over the rounds walked (``rounds[:upto]``, the port's
    ``locate_rounds``).  Returns the number of tokens compared."""
    upto = len(rounds) if upto is None else upto
    cut = {b.bid: 0 for b in tsch.batches}
    for bid, rnd, *_ in rounds[:upto]:
        cut[bid] = rnd + 1
    for i in ties:
        bid, rnd = rounds[i][:2]
        cut[bid] = min(cut[bid], rnd)
    checked = 0
    for jb, tb in zip(jsch.batches, tsch.batches):
        c = cut[tb.bid]
        for slot in range(len(tb.plan.requests)):
            if tb.plan.valid[slot]:
                np.testing.assert_array_equal(
                    np.asarray(tb.outputs)[slot][:c],
                    np.asarray(jb.outputs)[slot][:c])
                checked += c
    return checked
