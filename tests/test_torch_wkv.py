"""The port's RWKV6 wkv recurrence against the reference's, on the CPU.

The reference's kernel (``repro.kernels.ssm_scan.wkv``) runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it; the port's wrapper
takes its plain version for CPU tensors. Inputs come from numpy with a
seed (bf16: the same draws rounded by both frameworks).

Tolerance: 20x the reference's kernel tolerance (5e-5 f32, 5e-2 bf16)
for y and the final state, the reference's own (``test_wkv_sweep``);
the emulated CUDA summation order is also held to
``ops.bf16_error_bound``, the card's per-element gate on bf16's y."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import wkv as jwkv
from repro.kernels.ssm_scan import wkv_ref as jwkv_ref
from repro_torch.kernels.ssm_scan import ops, wkv, wkv_ref

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
SWEEP = [(1, 2, 32, 16, 8), (2, 3, 50, 16, 16), (1, 4, 64, 64, 64),
         (2, 1, 17, 8, 8)]


def _inputs(B, H, T, dk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
    arrs = (r, k, v, w, u)
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_kernel(B, H, T, dk, chunk, dtype):
    jargs, args = _inputs(B, H, T, dk, dtype, seed=T + dk)
    y_ref, S_ref = jwkv(*jargs, chunk=chunk)
    y, S = wkv(*args)
    assert y.dtype == args[0].dtype and S.dtype == torch.float32
    tol = 20 * TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(S), _np(S_ref), atol=tol, rtol=tol)


def test_state_resumes():
    """The final state of the first half, fed to the plain recurrence for
    the second half, gives the state of the whole sequence: serving can
    resume from the prefill's state."""
    jargs, args = _inputs(1, 2, 24, 16, "float32", seed=1)
    *rkvw, u = args
    _, S_half = wkv(*(a[:, :, :12] for a in rkvw), u)
    _, S_half_ref = jwkv(*(a[:, :, :12] for a in jargs[:4]), jargs[4],
                         chunk=4)
    np.testing.assert_allclose(_np(S_half), _np(S_half_ref), atol=1e-5)
    _, S_full = wkv_ref(*(a[:, :, 12:] for a in rkvw), u, S0=S_half)
    _, S_direct = jwkv_ref(*jargs)
    np.testing.assert_allclose(_np(S_full), _np(S_direct), atol=1e-5)


def test_wrapper_checks():
    _, (r, k, v, w, u) = _inputs(1, 2, 5, 8, "float32")
    with pytest.raises(ValueError, match="one shape"):
        wkv(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, w, u[:, :4])
    with pytest.raises(TypeError, match="one dtype"):
        wkv(r, k, v, w.double(), u)
    with pytest.raises(ValueError, match="unsupported device"):
        wkv(*(a.to("meta") for a in (r, k, v, w, u)))
    before = wkv.launches
    wkv(r, k, v, w, u)                  # the CPU path launches nothing
    assert wkv.launches == before


def _kernel_emulation(r, k, v, w, u):
    """The CUDA kernel's summation order, emulated in f32 on the CPU (the
    kernel runs only on the card): dk padded with zero channels to its
    instance width (16, 32 or 64); each lane of a value column owns 4 key
    rows and takes sum_i r_i S[i][j] + (sum_i r_i u_i k_i) v_j over them;
    the lanes' shares are summed by a butterfly (the halves at distance
    R/2 first, then R/4, ..); S_t = w S_{t-1} + k vᵀ."""
    B, H, T, dk = r.shape
    DK = 16 if dk <= 16 else 32 if dk <= 32 else 64
    R = DK // 4

    def pad(a):
        return torch.nn.functional.pad(a.float(), (0, DK - dk))

    rf, kf, vf, wf, uf = (pad(a) for a in (r, k, v, w, u))
    S = torch.zeros((B, H, DK, DK))
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t] for a in (rf, kf, vf, wf))
        dot = (rt[..., :, None] * S).reshape(B, H, R, 4, DK).sum(3)
        bonus = (rt * uf * kt).reshape(B, H, R, 4).sum(-1)
        part = dot + bonus[..., None] * vt[:, :, None, :]
        while part.shape[2] > 1:
            half = part.shape[2] // 2
            part = part[:, :, :half] + part[:, :, half:]
        ys.append(part[:, :, 0, :dk])
        S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=2).to(r.dtype), S[..., :dk, :dk]


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_summation_order_matches_reference_kernel(B, H, T, dk, chunk,
                                                         dtype):
    """The kernel's order of summation (the bonus term per lane, a tree
    over the lanes, zero-padded channels) against the reference's Pallas
    kernel at the reference's tolerance for this kernel (20x)."""
    jargs, args = _inputs(B, H, T, dk, dtype, seed=T + dk)
    y_ref, S_ref = jwkv(*jargs, chunk=chunk)
    y, S = _kernel_emulation(*args)
    tol = 20 * TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(S), _np(S_ref), atol=tol, rtol=tol)


def test_kernel_summation_order_ragged_dk():
    """dk = 50 (padded to 64) and dk = 24 (padded to 32) against the
    reference's oracle at the f32 tolerance."""
    for dk in (50, 24):
        jargs, args = _inputs(2, 2, 21, dk, "float32", seed=dk)
        y, S = _kernel_emulation(*args)
        y_ref, S_ref = jwkv_ref(*jargs)
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(S), _np(S_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,T,dk", [(1, 2, 32, 16), (2, 3, 50, 16),
                                      (1, 4, 64, 64), (2, 2, 40, 50)])
def test_bf16_error_bound_holds_for_the_kernel_order(B, H, T, dk):
    """``ops.bf16_error_bound``, the card's per-element gate on bf16's y,
    holds for the kernel's order of summation against the plain version,
    and S stays at the f32 tolerance."""
    _, args = _inputs(B, H, T, dk, "bfloat16", seed=T + dk)
    y_ref, S_ref = wkv_ref(*args)
    y, S = _kernel_emulation(*args)
    err = (y.float() - y_ref.float()).abs()
    assert (err <= ops.bf16_error_bound(y_ref)).all()
    torch.testing.assert_close(S, S_ref, atol=20 * TOL["float32"],
                               rtol=20 * TOL["float32"])


def test_bf16_error_bound_catches_a_lost_bonus_term():
    """y without the bonus term (u k v) breaks ``ops.bf16_error_bound``,
    while the reference's 20x bf16 tolerance (1.0) lets it pass."""
    _, (r, k, v, w, u) = _inputs(2, 2, 40, 64, "bfloat16", seed=1)
    y_ref, _ = wkv_ref(r, k, v, w, u)
    y, _ = _kernel_emulation(r, k, v, w, torch.zeros_like(u))
    err = (y.float() - y_ref.float()).abs()
    assert (err > ops.bf16_error_bound(y_ref)).any()
    tol = 20 * TOL["bfloat16"]
    assert torch.allclose(y.float(), y_ref.float(), atol=tol, rtol=tol)


# ------------------------------------------------------------- backward
# The reference has no Pallas backward: its LM differentiates the plain
# recurrence. So the port's gradient (autograd through ``wkv_ref`` on the
# CPU; the backward kernel on the card) is held against ``jax.vjp`` of the
# reference's plain version, within 1e-4 of each gradient's largest entry
# (f32 sums over up to T steps in another order; the kernel is at most
# 1.9e-6 from autograd of the plain version on an H100, ``chip_smoke.py``
# 6b).
GRAD_TOL = 1e-4


def _grad_inputs(B, H, T, dk, seed):
    jargs, args = _inputs(B, H, T, dk, "float32", seed=seed)
    dy = np.random.default_rng(seed + 1).standard_normal(
        (B, H, T, dk)).astype(np.float32)
    return jargs, args, dy


def _reference_grads(jargs, dy):
    """(dr, dk, dv, dw, du) of Σ y·dy by ``jax.vjp`` of the reference's
    plain recurrence (the final state gets no cotangent)."""
    (y, S), vjp = jax.vjp(lambda *a: jwkv_ref(*a), *jargs)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.zeros_like(S)))]


def _close_grads(got, ref, what=""):
    for name, g, gr in zip("rkvwu", got, ref):
        scale = np.abs(gr).max()
        np.testing.assert_allclose(_np(g), gr, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL, err_msg=f"{what} d{name}")


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP)
def test_plain_gradient_matches_reference(B, H, T, dk, chunk):
    jargs, args, dy = _grad_inputs(B, H, T, dk, seed=T + dk)
    args = [a.requires_grad_() for a in args]
    y, _ = wkv(*args)
    y.backward(torch.tensor(dy))
    _close_grads([a.grad for a in args], _reference_grads(jargs, dy))


def _bwd_emulation(r, k, v, w, u, dy, chunk=ops.BWD_CHUNK, stale=False,
                   wrong_group=False):
    """The backward kernel's algorithm in f32 on the CPU. A forward pass
    stores the state at the start of every chunk. The chunks are taken last
    to first, each in two halves (the later half first): the half's states S_{t-1} are built forward once from the
    chunk's stored state (never by dividing by w), then its steps run in
    reverse with G_{t-1} = w_t G_t + r_t dy_tᵀ from G_T = 0. The value
    columns are split into groups of ``ops.BWD_COLUMNS``: each group's dr,
    dk, dw sum over its own columns (the first group's with the bonus
    terms), and the groups' partials are added in group order; dv sums over
    the rows in the group; du sums over time per batch item, then over the
    batch. ``stale`` builds from the previous chunk's state, and
    ``wrong_group`` adds the first group's partial in place of the last
    one's (faulty kernels)."""
    B, H, T, dk = r.shape
    n_ch = -(-T // chunk)
    half = chunk // 2
    groups = [slice(c, min(c + ops.BWD_COLUMNS, dk))
              for c in range(0, dk, ops.BWD_COLUMNS)]
    kv = k[..., :, None] * v[..., None, :]
    S = torch.zeros((B, H, dk, dk))
    starts = []
    for c in range(n_ch):
        starts.append(S)
        for t in range(c * chunk, min((c + 1) * chunk, T)):
            S = w[:, :, t, :, None] * S + kv[:, :, t]
    parts = [[torch.zeros((B, H, T, dk)) for _ in range(3)] for _ in groups]
    dv = torch.zeros((B, H, T, dk))
    du_part = torch.zeros((B, H, dk))
    G = torch.zeros((B, H, dk, dk))
    for c in reversed(range(n_ch)):
        t0 = c * chunk
        nt = min(chunk, T - t0)
        for h0 in (half, 0):
            hn = min(half, nt - h0)
            if hn <= 0:
                continue
            Sp = starts[max(c - 1, 0)] if stale else starts[c]
            for t in range(t0, t0 + h0):
                Sp = w[:, :, t, :, None] * Sp + kv[:, :, t]
            states = []
            for t in range(t0 + h0, t0 + h0 + hn):
                states.append(Sp)
                Sp = w[:, :, t, :, None] * Sp + kv[:, :, t]
            for s in reversed(range(hn)):
                t = t0 + h0 + s
                Sp = states[s]
                rt, kt, vt, wt, gt = (a[:, :, t] for a in (r, k, v, w, dy))
                vdy = (vt * gt).sum(-1, keepdim=True)
                ruk = (rt * u * kt).sum(-1, keepdim=True)
                for n, cols in enumerate(groups):
                    dr_g, dk_g, dw_g = parts[n]
                    dr_g[:, :, t] = (Sp[..., cols] * gt[:, :, None, cols]).sum(-1)
                    dk_g[:, :, t] = (G[..., cols] * vt[:, :, None, cols]).sum(-1)
                    dw_g[:, :, t] = (G[..., cols] * Sp[..., cols]).sum(-1)
                    if n == 0:
                        dr_g[:, :, t] += u * kt * vdy[..., 0:1]
                        dk_g[:, :, t] += u * rt * vdy[..., 0:1]
                dv[:, :, t] = (G * kt[..., :, None]).sum(-2) + ruk * gt
                du_part = du_part + rt * kt * vdy
                G = wt[..., :, None] * G + rt[..., :, None] * gt[..., None, :]
    order = list(range(len(groups)))
    if wrong_group:
        order[-1] = 0
    dr_, dk_, dw = (sum((parts[n][a] for n in order[1:]), parts[order[0]][a])
                    for a in range(3))
    return dr_, dk_, dv, dw, du_part.sum(0)


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP + [(2, 2, 40, 50, 8),
                                              (1, 2, 37, 40, 8),
                                              (2, 1, 7, 64, 8),
                                              (1, 2, 25, 33, 8)])
def test_backward_kernel_algorithm_matches_reference(B, H, T, dk, chunk):
    """The backward kernel's algorithm (chunk-start states, each half
    chunk's states built forward once, the reverse G recurrence, column
    groups' partials added in order, du over time then batch) against
    ``jax.vjp`` of the reference, also with decays near 0 (no division by
    w anywhere); T off the chunk and its halves, one and two column
    groups."""
    jargs, args, dy = _grad_inputs(B, H, T, dk, seed=T + dk)
    w = args[3].numpy().copy()
    w[..., :3, :] = 1e-7
    jargs[3], args[3] = jnp.asarray(w), torch.tensor(w)
    got = _bwd_emulation(*args, torch.tensor(dy))
    _close_grads(got, _reference_grads(jargs, dy))


def test_backward_algorithm_check_catches_a_wrong_column_group():
    """Adding the first column group's partial in place of the second's
    breaks the gradient gate (dk = 64: two groups of 32 columns)."""
    jargs, args, dy = _grad_inputs(1, 2, 40, 64, seed=6)
    ref = _reference_grads(jargs, dy)
    _close_grads(_bwd_emulation(*args, torch.tensor(dy)), ref)
    got = _bwd_emulation(*args, torch.tensor(dy), wrong_group=True)
    with pytest.raises(AssertionError):
        _close_grads(got, ref)


def test_backward_algorithm_check_catches_a_stale_state():
    """Rebuilding S_{t-1} from the wrong chunk's state (the previous one)
    breaks the gradient gate."""
    jargs, args, dy = _grad_inputs(1, 2, 40, 16, seed=5)
    got = _bwd_emulation(*args, torch.tensor(dy), stale=True)
    with pytest.raises(AssertionError):
        _close_grads(got, _reference_grads(jargs, dy))


def test_cuda_style_call_keeps_the_gradient(monkeypatch):
    """A CUDA call's output comes from a ctypes launch and carries no
    ``grad_fn``. Under grad, the card path now goes through ``WKV``, whose
    backward launches the backward kernel: with both launches stubbed by
    plain computations on CPU tensors (the stubs' outputs detached, as a
    launch's are), r, k, v, w and u get the reference's gradients and the
    counters count one launch each way. Without grad it is one forward
    launch. A nonzero gradient of the final state S is passed to the
    backward launch; bf16 inputs that require a gradient take the same
    route."""
    jargs, args, dy = _grad_inputs(2, 2, 20, 16, seed=3)

    def launch(r, k, v, w, u):
        y, S = wkv_ref(r, k, v, w, u)
        return y.detach(), S.detach()

    def launch_bwd(r, k, v, w, u, dy, dS=None):
        return tuple(g.detach() for g in _bwd_emulation(r, k, v, w, u, dy))

    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_bwd", launch_bwd)
    before = (wkv.launches, wkv.bwd_launches)
    args = [a.requires_grad_() for a in args]
    y, S = ops._on_card(*args)
    assert y.grad_fn is not None
    y.backward(torch.tensor(dy))
    assert (wkv.launches, wkv.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(a.grad is not None for a in args)
    _close_grads([a.grad for a in args], _reference_grads(jargs, dy))
    with torch.no_grad():
        y, _ = ops._on_card(*args)
    assert y.grad_fn is None and wkv.launches == before[0] + 2
    # a nonzero final-state gradient reaches the backward launch, and bf16
    # inputs that require a gradient go through ``WKV`` as f32 ones do
    seen = []

    def record(*a):
        seen.append(a)
        return tuple(torch.zeros_like(t) for t in a[:5])

    monkeypatch.setattr(ops, "_launch_bwd", record)
    y, S = ops._on_card(*args)
    (y.sum() + S.sum()).backward()
    assert len(seen) == 1 and torch.equal(seen[0][6], torch.ones_like(S))
    xb = [a.detach().bfloat16().requires_grad_() for a in args[:4]]
    y, _ = ops._on_card(*xb, args[4])
    assert y.dtype == torch.bfloat16 and y.grad_fn is not None
    y.float().sum().backward()
    assert seen[1][6] is None and seen[1][0].dtype == torch.bfloat16
    assert all(a.grad is not None and a.grad.dtype == torch.bfloat16
               for a in xb)
