"""The gradient of the chunked SSD scan, against the reference's.

The reference trains Mamba2 and zamba2 through XLA's autodiff of
``repro.kernels.ref.ssd_chunked_ref`` (its Pallas kernel has no
backward), so that is the gradient the port must give.  On the same
numpy inputs: ``ref.ssd_chunked_bwd_ref`` (the plain version of B7's
backward kernels, the algebra written out) and autograd of the port's
``ref.ssd_chunked_ref`` against ``jax.grad`` of the reference's, with
and without h0 and a gradient of h_final, over several chunk lengths, S
not a multiple of the kernel's 32, S = 1 and strong decay.  Then the
wiring the card uses, on the CPU: ``SsdFn`` with its two launches
replaced by their plain versions, its refusal of a double backward,
``ops.ssd``'s choice of it under grad, remat, and one reduced mamba2 and
one zamba2 ``train_step`` through it against the reference's step.

Tolerances: gradients within rtol 1e-5 and atol 1e-5 x the output's max
|grad| (fp32 sums taken in another order, over up to a few hundred
terms), but d a_log within atol 1e-4 x its max: it sums d la_t la_t over
every (stream, step), terms that cancel, so its rounding follows their
magnitudes, not the result's.  The train step uses
``tests/test_torch_train.py``'s rules, with the same exception for the
a_log leaf, whose gradient is that sum.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import ShapeConfig  # noqa: E402
from repro.data.synthetic import synthetic_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import init_opt_state as j_init_opt  # noqa: E402
from repro.training import TrainConfig as JTrain  # noqa: E402
from repro.training import train_step as j_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build, flash_attention, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunk  # noqa: E402
from repro_torch.optim import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.training import TrainConfig, train_step  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")
RTOL, ATOL = 1e-5, 1e-5
ATOL_DA_LOG = 1e-4
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5          # tests/test_torch_train.py's

# (id, (B, S, H, P, N), chunk, strong decay, h0, dh_final)
CASES = [
    ("base", (2, 16, 3, 8, 16), 8, False, False, False),
    ("h0", (2, 16, 3, 8, 16), 8, False, True, False),
    ("dh_final", (2, 16, 3, 8, 16), 8, False, False, True),
    ("h0+dh_final", (2, 16, 3, 8, 16), 8, False, True, True),
    ("chunk 4", (2, 16, 3, 8, 16), 4, False, True, True),
    ("one chunk", (2, 16, 3, 8, 16), 16, False, True, True),
    ("S=33 chunk 11", (2, 33, 3, 8, 16), 11, False, True, True),
    ("S=40 P=16 N=32", (2, 40, 2, 16, 32), 8, False, False, True),
    ("S=1", (3, 1, 2, 8, 16), 1, False, True, True),
    ("strong decay", (2, 24, 3, 8, 16), 8, True, True, True),
    ("strong decay S=33", (1, 33, 2, 8, 16), 33, True, False, False),
]


def _inputs(seed, b, s, h, p, n, strong=False, h0=False, dh_final=False):
    """numpy inputs as the Mamba2 block hands them over: dt softplus'd,
    a_log over [log 1, log 16] (all log 16 and dt ~ 5 under strong decay,
    so that the log decay of a chunk reaches -10^3 and exp(L) underflows),
    and the output gradients."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) + (5.0 if strong else 0.0)))
    a_log = np.log(np.linspace(1.0, 16.0, h))
    if strong:
        a_log[:] = math.log(16.0)
    bb = rng.randn(b, s, n).astype(np.float32)
    cc = rng.randn(b, s, n).astype(np.float32)
    d = rng.randn(h).astype(np.float32)
    hh = rng.randn(b, h, p, n).astype(np.float32) if h0 else None
    dy = rng.randn(b, s, h, p).astype(np.float32)
    dh = rng.randn(b, h, p, n).astype(np.float32) if dh_final else None
    return (x, dt.astype(np.float32), a_log.astype(np.float32), bb, cc, d,
            hh, dy, dh)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, name):
    want = np.asarray(want)
    atol = ATOL_DA_LOG if name == "da_log" else ATOL
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _reference_grads(arrays, chunk):
    """jax.grad of <y, dy> (+ <h_final, dh_final>) through the reference's
    chunked scan: (dx, ddt, da_log, db, dc, dd[, dh0])."""
    x, dt, a_log, bb, cc, d, hh, dy, dh = arrays

    def f(*args):
        h0 = args[6] if len(args) > 6 else None
        y, hf = jref.ssd_chunked_ref(*args[:6], h0=h0, chunk=chunk)
        out = jnp.vdot(y, dy)
        return out if dh is None else out + jnp.vdot(hf, dh)

    args = [jnp.asarray(a) for a in (x, dt, a_log, bb, cc, d, hh)
            if a is not None]
    return jax.jit(jax.grad(f, argnums=tuple(range(len(args)))))(*args)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_jax_grad(case):
    _, shape, chunk, strong, with_h0, with_dh = case
    arrays = _inputs(sum(shape), *shape, strong, with_h0, with_dh)
    want = _reference_grads(arrays, chunk)
    x, dt, a_log, bb, cc, d, hh, dy, dh = (_t(a) for a in arrays)
    plain = ref.ssd_chunked_bwd_ref(x, dt, a_log, bb, cc, d, dy, h0=hh,
                                    dh_final=dh, chunk=chunk)
    assert (plain[-1] is None) == (hh is None)
    leaves = [t.requires_grad_(True) for t in (x, dt, a_log, bb, cc, d, hh)
              if t is not None]
    y, hf = ref.ssd_chunked_ref(*leaves[:6], h0=hh, chunk=chunk)
    loss = (y * dy).sum() + (0.0 if dh is None else (hf * dh).sum())
    auto = torch.autograd.grad(loss, leaves)
    for name, got_auto, got_plain, w in zip(NAMES, auto, plain, want):
        assert torch.isfinite(got_plain).all(), name
        assert got_plain.dtype == got_auto.dtype == torch.float32
        _close(got_auto, w, name)
        _close(got_plain, w, name)


def test_backward_does_not_depend_on_the_chunk():
    """The chunked algebra is exact: chunks of 1, 4, 8 and 24 steps give
    one gradient up to rounding (the kernel tiles S by its own 32)."""
    arrays = [_t(a) for a in _inputs(5, 2, 24, 3, 8, 16, h0=True,
                                     dh_final=True)]
    x, dt, a_log, bb, cc, d, hh, dy, dh = arrays
    grads = {q: ref.ssd_chunked_bwd_ref(x, dt, a_log, bb, cc, d, dy, h0=hh,
                                        dh_final=dh, chunk=q)
             for q in (1, 4, 8, 24)}
    for q in (1, 4, 8):
        for name, g, w in zip(NAMES, grads[q], grads[24]):
            _close(g, w.numpy(), name)


def test_backward_keeps_the_input_dtypes():
    """bf16 x, b, c and dy give bf16 dx, db, dc; dt, a_log, d_skip and h0
    keep theirs; each close to the fp32 gradient of the same values."""
    arrays = [_t(a) for a in _inputs(6, 2, 16, 2, 8, 16, h0=True,
                                     dh_final=True)]
    x, dt, a_log, bb, cc, d, hh, dy, dh = arrays
    low = [t.to(torch.bfloat16) for t in (x, bb, cc, dy)]
    got = ref.ssd_chunked_bwd_ref(low[0], dt, a_log, low[1], low[2], d,
                                  low[3], h0=hh, dh_final=dh, chunk=8)
    want = ref.ssd_chunked_bwd_ref(
        *(t.float() for t in low[:1]), dt, a_log,
        *(t.float() for t in low[1:3]), d, low[3].float(), h0=hh,
        dh_final=dh, chunk=8)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "db", "dc")
                           else torch.float32), name
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()),
                                   err_msg=name)


def _plain_launches(monkeypatch, chunk):
    """Replace B7's launches (forward and backward) by their plain
    versions at ``chunk``, counting calls and whether the backward got a
    gradient of h_final."""
    calls = {"forward": 0, "backward": 0, "dh_final": []}

    def forward(x, dt, a_log, b, c, d_skip, h0=None):
        calls["forward"] += 1
        return ref.ssd_chunked_ref(x, dt, a_log, b, c, d_skip, h0=h0,
                                   chunk=chunk)

    def backward(x, dt, a_log, b, c, d_skip, dy, h0=None, dh_final=None):
        calls["backward"] += 1
        calls["dh_final"].append(dh_final is not None)
        return ref.ssd_chunked_bwd_ref(x, dt, a_log, b, c, d_skip, dy,
                                       h0=h0, dh_final=dh_final, chunk=chunk)

    monkeypatch.setattr(ssd_scan, "ssd_chunked", forward)
    monkeypatch.setattr(ssd_scan, "ssd_chunked_bwd", backward)
    return calls


def _plain_attention(monkeypatch):
    """B3's two launches by their plain versions (zamba2's "G" block)."""
    def forward(q, k, v, return_lse=False, **rule):
        out = ref.attention_ref(q, k, v, **rule)
        return (out, ref.attention_lse_ref(q, k, **rule)) if return_lse \
            else out

    monkeypatch.setattr(flash_attention, "flash_attention", forward)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd",
                        ref.attention_bwd_ref)


@pytest.mark.parametrize("with_h0,use_y,use_state",
                         [(False, True, False), (True, True, True),
                          (True, False, True), (False, True, True)],
                         ids=["y", "h0 y state", "h0 state", "y state"])
def test_autograd_function_wiring(monkeypatch, with_h0, use_y, use_state):
    """``SsdFn`` saves the inputs its backward launch reads and hands the
    gradients back in order: with plain launches it gives the reference's
    gradients, one launch each way; an unused h_final reaches the
    backward as None (an unused y as zeros)."""
    chunk = 8
    calls = _plain_launches(monkeypatch, chunk)
    arrays = _inputs(21, 2, 16, 3, 8, 16, h0=with_h0, dh_final=True)
    x, dt, a_log, bb, cc, d, hh, dy, dh = arrays
    leaves = [_t(a).requires_grad_(True) for a in (x, dt, a_log, bb, cc, d,
                                                    hh) if a is not None]
    y, hf = ssd_scan.SsdFn.apply(*leaves[:6],
                                 leaves[6] if with_h0 else None)
    loss = (y * _t(dy)).sum() if use_y else 0.0
    if use_state:
        loss = loss + (hf * _t(dh)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert calls == {"forward": 1, "backward": 1, "dh_final": [use_state]}
    want = _reference_grads((x, dt, a_log, bb, cc, d, hh,
                             dy if use_y else np.zeros_like(dy),
                             dh if use_state else None), chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def test_autograd_function_refuses_double_backward(monkeypatch):
    """The backward kernels write their gradients by pointer and have no
    backward of their own: a second-order gradient through ``SsdFn``
    raises instead of silently losing its terms."""
    _plain_launches(monkeypatch, 8)
    x, dt, a_log, bb, cc, d, _, dy, _ = _inputs(22, 1, 8, 2, 8, 16)
    leaves = [_t(a).requires_grad_(True) for a in (x, dt, a_log, bb, cc, d)]
    y, _ = ssd_scan.SsdFn.apply(*leaves, None)
    dy = _t(dy).requires_grad_(True)
    dx = torch.autograd.grad(y, leaves, dy, create_graph=True)[0]
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


def test_ops_routes_grad_to_the_autograd_function(monkeypatch):
    """On the card ``ops.ssd`` takes ``SsdFn`` when grad is enabled and an
    input requires it (a parameter such as a_log is enough), and the
    plain launch otherwise."""
    calls = _plain_launches(monkeypatch, 8)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    x, dt, a_log, bb, cc, d, _, dy, _ = (
        _t(a) for a in _inputs(23, 1, 8, 2, 8, 16))
    y, _ = ops.ssd(x, dt, a_log, bb, cc, d)
    assert y.grad_fn is None and calls["forward"] == 1
    a_req = a_log.clone().requires_grad_(True)
    with torch.no_grad():
        y, _ = ops.ssd(x, dt, a_req, bb, cc, d)
    assert y.grad_fn is None
    y, h_final = ops.ssd(x, dt, a_req, bb, cc, d)
    assert y.grad_fn is not None and h_final.grad_fn is not None
    y.backward(dy)
    assert calls["forward"] == 3 and calls["backward"] == 1
    assert a_req.grad is not None and a_req.grad.abs().sum() > 0


def test_head_sum_adds_the_heads_in_order():
    """The backward's second launch, plain: (2, B, H, S, N) per-head
    partials of db and dc -> their sums over the heads, in the dtype
    asked for."""
    parts = torch.from_numpy(np.random.RandomState(25).randn(
        2, 2, 3, 5, 16).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        db, dc = ref.ssd_bwd_head_sum_ref(parts, dtype)
        assert db.dtype == dc.dtype == dtype and db.shape == (2, 5, 16)
        np.testing.assert_allclose(db.float().numpy(),
                                   parts[0].sum(1).to(dtype).float().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dc.float().numpy(),
                                   parts[1].sum(1).to(dtype).float().numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, dt, a_log, bb, cc, d, _, dy, _ = (
        _t(a) for a in _inputs(24, 1, 8, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunked_bwd(x, dt, a_log, bb, cc, d, dy)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_bwd_head_sum(torch.zeros(2, 1, 2, 8, 16),
                                  torch.float32)
    assert {"ssd_chunked_bwd", "ssd_bwd_head_sum"} <= set(ops.KERNELS)
    assert ops.KERNELS["ssd_chunked_bwd"].source == "ssd_scan_bwd.cu"
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.bwd_info(64, 128, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_backward_rows_are_copied_only_when_unaligned(dtype):
    """The backward copies x, b, c and dy into shared memory 16 bytes at a
    time, so its wrapper hands them over through ``_rows``: the Mamba2
    block's strided views of one conv output (mamba2-780m's widths) go in
    place, a view whose rows are not 16-byte aligned as an equal
    contiguous copy."""
    h, p, n = 48, 64, 128
    xbc = torch.zeros(2, 8, h * p + 2 * n, dtype=dtype)
    for view in (xbc[..., :h * p].unflatten(-1, (h, p)),
                 xbc[..., h * p:h * p + n], xbc[..., h * p + n:]):
        assert ssd_scan._rows(view) is view
    odd = torch.arange(2 * 8 * 17, dtype=torch.float32).to(dtype).reshape(
        2, 8, 17)[..., 1:]
    copy = ssd_scan._rows(odd)
    assert copy is not odd and copy.is_contiguous()
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, odd)


def _variants_script():
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "ssd_bwd_variants.py")
    spec = importlib.util.spec_from_file_location("ssd_bwd_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["base", "states_in_smem",
                                     "no_partials", "neither"])
def test_backward_variants_patch_the_kernel_once(variant):
    """``scripts/ssd_bwd_variants.py`` builds its diagnostic variants by
    replacing lines of ``csrc/ssd_scan_bwd.cu``: each line it replaces is
    in the kernel's source exactly once, so a variant differs from the
    kernel in those lines alone."""
    script = _variants_script()
    source = (build.CSRC_DIR / "ssd_scan_bwd.cu").read_text()
    edits = script.VARIANTS[variant]
    out = script.patched(source, edits)
    assert (out == source) == (not edits)
    for old, new in edits:
        assert source.count(old) == 1 and new in out
    # one line of the kernel changed by each edit
    assert len(set(out.splitlines()) - set(source.splitlines())) == len(edits)
    with pytest.raises(SystemExit, match="exactly once"):
        script.patched(source, [("no such line", "")])


def _flat(tree):
    return {keystr(p): v for p, v in flatten_with_path(tree)}


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_close(got, want, what):
    """The train tests' gradient rule; a_log's leaf (d a_log, see the top)
    within ATOL_DA_LOG x its max instead of GRAD_ATOL."""
    want = np.asarray(want, np.float32)
    atol = ATOL_DA_LOG if what.endswith("['a_log']") else GRAD_ATOL
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=GRAD_RTOL,
        atol=atol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _batch(cfg, seed=0):
    return synthetic_batch(cfg, ShapeConfig("t", 16, 2, "train"),
                           np.random.RandomState(seed))


# zamba2 at "SGSG": the shared block used twice, so that its gradient
# is the sum over its uses
TRAIN_CASES = [("mamba2-780m", {}),
               ("zamba2-1.2b", dict(num_layers=4, layer_pattern="SGSG"))]


@pytest.mark.parametrize("arch,updates", TRAIN_CASES,
                         ids=[a for a, _ in TRAIN_CASES])
def test_train_step_through_the_autograd_function(monkeypatch, arch,
                                                  updates):
    """One reduced ``train_step`` with every kernel routed as on the card
    (``SsdFn``, and ``FlashAttentionFn`` for zamba2's "G" block) but
    launched as plain versions, against the reference's jitted step from
    its own parameters: one forward and one backward launch a Mamba2
    layer; loss and metrics, gradients (from the reference's first
    moments; the shared block's summed over its two uses) and updated
    parameters under the train tests' rules."""
    jc = jconfigs.get_reduced(arch).with_updates(**updates)
    tc = configs.get_reduced(arch).with_updates(**updates)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    jo = j_init_opt(jp)
    batch = _batch(tc)
    with jops.force_kernel("xla"):
        jp1, jo1, jm = jax.jit(lambda p, o, b: j_train_step(
            jc, JTrain(optimizer=JOpt(**OPT)), p, o, b))(
                jp, jo, jax.tree.map(jnp.asarray, batch))
    calls = _plain_launches(monkeypatch,
                            ssd_chunk(tc.ssm_chunk, batch["tokens"].shape[1]))
    _plain_attention(monkeypatch)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
    tp = params_from_jax(jp, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads = loss_and_grads(tc, tcfg, tp, tbatch)
    layers = tc.layer_pattern.count("S")
    assert calls == {"forward": layers, "backward": layers,
                     "dh_final": [False] * layers}
    b1 = tcfg.optimizer.b1
    clipped = {k: v / (1 - b1) for k, v in _jflat(jo1.mu).items()}
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    for key, g in _flat(grads).items():
        _grad_close(g * scale, clipped[key], key)
    new_p, _, m = train_step(tc, tcfg, tp, init_opt_state(tp), tbatch)
    for key, val in m.items():
        np.testing.assert_allclose(float(val), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    lr, wd = float(jm["lr"]), tcfg.optimizer.weight_decay
    before, want = _jflat(jp), _jflat(jp1)
    for key, val in _flat(new_p).items():
        g, w = val.float().numpy(), want[key]
        diff = np.abs(g - w)
        assert (diff <= 2 * lr * (1 + wd * np.abs(before[key])) + 1e-6).all()
        sure = np.abs(clipped[key]) > 100 * GRAD_ATOL * max(
            float(np.abs(clipped[key]).max()), 1e-30)
        assert (diff[sure] <= 1e-5 * np.abs(w[sure]) + 0.02 * lr).all(), key


def test_remat_launches_the_forward_again(monkeypatch):
    """Under ``cfg.remat`` each Mamba2 block's forward is launched again
    when the block is recomputed, the backward once, and the gradients
    are those without remat."""
    tc = configs.get_reduced("mamba2-780m")
    params = params_from_jax(j_init_params(jconfigs.get_reduced(
        "mamba2-780m"), jax.random.PRNGKey(1)), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc, 3).items()}
    calls = _plain_launches(monkeypatch, 16)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    got = {}
    for remat in (False, True):
        calls.update(forward=0, backward=0, dh_final=[])
        got[remat] = loss_and_grads(dataclasses.replace(tc, remat=remat),
                                    TrainConfig(), params, batch)
        assert (calls["forward"], calls["backward"]) == (
            tc.num_layers * (2 if remat else 1), tc.num_layers)
    assert float(got[True][0]) == float(got[False][0])
    for key, g in _flat(got[True][2]).items():
        _grad_close(g, _flat(got[False][2])[key].numpy(), key)
