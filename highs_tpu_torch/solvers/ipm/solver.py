"""Interior-point LP solver on torch.

The JAX package's `ipm/solver.py` (reference: highs/ipm/hipo/ipm/Solver.cpp
regularized predictor-corrector; highs/ipm/ipx/ipm.cc Mehrotra
predictor-corrector): each Newton system is solved through the normal
equations

    (K Theta_x K' + Theta_s + delta_d I) dy = r

on the standard form produced by the PDHG preprocessor (equality rows
first, inequality rows get a surplus slack s >= 0, so the slack block
contributes only a diagonal on inequality rows).  Three routes:

  "chol"  K Theta K' formed dense in f64 (`torch.matmul`, the FP64
          tensor cores on an H100) and factored by a dense Cholesky, on
          the solver's device;
  "cg"    Jacobi-preconditioned conjugate gradients, matrix-free in M;
  "ldl"   M is assembled sparse on the host from a scipy copy of K and
          factored there, as in the JAX package: the banded f32
          Cholesky on the device (`banded_chol.py`) where M is banded
          and well enough conditioned, else SuperLU, else the native
          LDL' (`sparse_ldl.py`).  The iterate and the products with K
          stay on the device (K as sparse CSR tensors, `SparseK`).

One iteration: residuals -> Theta -> M -> factor -> predictor solve ->
affine steps -> mu_aff -> sigma = (mu_aff/mu)^3 -> corrector solve (same
factor) -> fraction-to-boundary steps -> update.  The host reads the
iteration's metrics once.  Fixed variables (l == u) are frozen out of
the barrier (Theta = 0, step 0); free variables get a capped Theta.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ...constants import HighsCallbackType as _CbT
from ...constants import HighsModelStatus
from ...device import resolve_device
from ...models.lp import HighsLp
from ...models.solution import HighsSolution
from ...options import HighsOptions
from ...ops.linops import _sparse_csr
from ..pdlp.preprocess import preprocess_lp, recover_solution
from ..pdlp.wrapper import _solve_bound_lp
from .banded_chol import BandedCholesky
from .sparse_ldl import LdlBlowup, SparseLdl

F64 = torch.float64
EPS = 1e-30


class SparseK(NamedTuple):
    """K of the sparse routes: a scipy CSR copy on the host (normal
    matrix, sparse factors, recovery) and K, K' as sparse CSR tensors on
    the solver's device (the iterate's products)."""
    host: sp.csr_matrix
    fwd: torch.Tensor
    bwd: torch.Tensor

    @property
    def shape(self):
        return self.host.shape


def sparse_k(a: sp.spmatrix, device) -> SparseK:
    a = sp.csr_matrix(a, dtype=np.float64)
    return SparseK(a, _sparse_csr(a, F64, device),
                   _sparse_csr(a.T.tocsr(), F64, device))


class IpmProblem(NamedTuple):
    # dense (m, n_std) standard-form K (scaled), or on the "ldl" route
    # and the sparse "cg" route a SparseK
    a: object
    b: torch.Tensor  # (m,) rhs
    c: torch.Tensor  # (n_std,) cost (minimization sense, scaled)
    slack_mask: torch.Tensor  # (m,) 1.0 on inequality rows (with slacks)
    # over the n_std + m stacked variables (x then row slacks):
    lo: torch.Tensor
    up: torch.Tensor
    lo_fin: torch.Tensor  # 1.0 where lower bound finite AND var not fixed
    up_fin: torch.Tensor  # 1.0 where upper bound finite AND var not fixed
    active: torch.Tensor  # 0.0 for fixed vars (l == u) and eq-row slacks
    norm_c: torch.Tensor
    norm_b: torch.Tensor


class IpmState(NamedTuple):
    x: torch.Tensor  # (n_std + m,) stacked primal (x, s)
    xl: torch.Tensor
    xu: torch.Tensor
    y: torch.Tensor  # (m,)
    zl: torch.Tensor
    zu: torch.Tensor


class IpmMetrics(NamedTuple):
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    mu: torch.Tensor
    primal_obj: torch.Tensor
    dual_obj: torch.Tensor
    alpha_p: torch.Tensor
    alpha_d: torch.Tensor


@dataclasses.dataclass
class IpmSettings:
    tolerance: float = 1e-9
    iteration_limit: int = 200
    time_limit: float = math.inf
    sigma_min: float = 1e-4
    sigma_max: float = 0.9
    fraction_to_boundary: float = 0.9995
    theta_max: float = 1e10
    reg_primal: float = 1e-10
    reg_dual: float = 1e-10


# dense Cholesky factors of the normal matrix, by device type: read like
# the kernels' launch counters, so that a run can show that its dense
# route ran on the card
DENSE_FACTORS = {"cuda": 0, "cpu": 0}

# persistent factor handles of the "ldl" route, keyed by the sparsity
# pattern of K (`_pattern_key`): the normal matrix's pattern is constant
# across a solve, so one symbolic analysis serves every iteration (the
# banded structure also by its device)
_LDL_CACHE: dict = {}
_BANDED_CACHE: dict = {}
# patterns that `BandedCholesky.from_spd` found not banded: a property of
# the pattern alone, so it holds for every later solve
_BANDED_REJECT: set = set()
# patterns whose banded factor failed the precision gate in the current
# solve: that depends on this solve's Theta, so `solve_lp_ipm_native`
# clears it when it starts
_BANDED_GATED: set = set()
# from this many rows of M the "ldl" route tries the banded device
# factor, then SuperLU; the native LDL' takes smaller ones
LARGE_M_ROWS = 20000


def _pattern_key(a: SparseK) -> tuple:
    """The sparsity pattern of K as a cache key."""
    digest = hashlib.blake2b(digest_size=16)
    digest.update(np.ascontiguousarray(a.host.indptr).tobytes())
    digest.update(np.ascontiguousarray(a.host.indices).tobytes())
    return a.shape, digest.hexdigest()


class PhaseClock:
    """Seconds spent in the Newton phases of an IPM solve: "normal"
    (forming the normal matrix), "factor" and "solve" (both Newton
    solves of an iteration).  On a CUDA device a phase is timed by CUDA
    events on the current stream, read after the iteration's metrics
    reach the host; elsewhere by the host clock."""

    PHASES = ("normal", "factor", "solve")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = dict.fromkeys(self.PHASES, 0.0)
        self._events = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self.seconds[name] += time.perf_counter() - t0
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events.append((name, start, end))

    def collect(self) -> None:
        """Add up the events recorded so far (after a sync)."""
        for name, start, end in self._events:
            self.seconds[name] += start.elapsed_time(end) / 1e3
        self._events.clear()


def _kx(a, v: torch.Tensor) -> torch.Tensor:
    """K v for a dense K or a SparseK."""
    return a @ v if isinstance(a, torch.Tensor) else a.fwd @ v


def _kty(a, y: torch.Tensor) -> torch.Tensor:
    """K' y for a dense K or a SparseK."""
    return y @ a if isinstance(a, torch.Tensor) else a.bwd @ y


def _host(v: torch.Tensor) -> np.ndarray:
    return v.cpu().numpy()


def _mv(problem: IpmProblem, xs: torch.Tensor) -> torch.Tensor:
    """[K, -I_slack] @ (x, s)."""
    n = problem.a.shape[1]
    return _kx(problem.a, xs[:n]) - problem.slack_mask * xs[n:]


def _rmv(problem: IpmProblem, y: torch.Tensor) -> torch.Tensor:
    """[K, -I_slack]' @ y."""
    return torch.cat([_kty(problem.a, y), -problem.slack_mask * y])


def _residuals(problem: IpmProblem, state: IpmState):
    m = problem.a.shape[0]
    c_full = torch.cat([problem.c, problem.c.new_zeros(m)])
    rb = problem.b - _mv(problem, state.x)
    rc = c_full - _rmv(problem, state.y) - state.zl + state.zu
    # stationarity on inactive (fixed) vars is satisfied by definition:
    # their reduced cost is free
    rc = rc * problem.active
    rl = (problem.lo - state.x + state.xl) * problem.lo_fin
    ru = (problem.up - state.x - state.xu) * problem.up_fin
    return rb, rc, rl, ru, c_full


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where `mat` is not positive definite
    (as jnp.linalg.cholesky answers), with no host sync."""
    chol, info = torch.linalg.cholesky_ex(mat)
    return torch.where(info == 0, chol, torch.nan)


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(rhs[:, None], chol)[:, 0]


def pcg(mdot, b: torch.Tensor, precond, tol: float = 1e-14,
        maxiter: int = 400, check_every: int = 16) -> torch.Tensor:
    """Preconditioned CG from x = 0 with the stopping rule of
    `jax.scipy.sparse.linalg.cg`: iterate while r'r > tol^2 b'b and fewer
    than `maxiter` iterations ran.  The rule is evaluated on the device
    every iteration (a finished solve stops changing) and read by the
    host every `check_every` iterations, not after each one."""
    atol2 = tol * tol * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    gamma = torch.dot(r, z)
    going = torch.ones((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter:
        for _ in range(min(check_every, maxiter - k)):
            going = going & (torch.dot(r, r) > atol2)
            ap = mdot(p)
            alpha = gamma / torch.dot(p, ap)
            x = torch.where(going, x + alpha * p, x)
            r_new = r - alpha * ap
            z = precond(r_new)
            gamma_new = torch.dot(r_new, z)
            p = torch.where(going, z + (gamma_new / gamma) * p, p)
            r = torch.where(going, r_new, r)
            gamma = torch.where(going, gamma_new, gamma)
            k += 1
        if not bool(going):
            break
    return x


def _dense_newton(problem: IpmProblem, theta_x, diag_extra, phase):
    """The "chol" route: M = (K Theta_x) K' + D formed dense, one
    Cholesky factor for both solves."""
    with phase("normal"):
        mmat = (problem.a * theta_x[None, :]) @ problem.a.T
        mmat = mmat + torch.diag(diag_extra)
    with phase("factor"):
        chol = cholesky(mmat)
    DENSE_FACTORS[mmat.device.type] += 1
    return lambda rhs_y: cho_solve(chol, rhs_y)


def _cg_newton(problem: IpmProblem, theta, theta_x, diag_extra, reg_d):
    """The "cg" route: matrix-free Jacobi-PCG on M,
    diag(M)_i = sum_j K_ij^2 theta_j + diag_extra_i."""
    a = problem.a
    if isinstance(a, torch.Tensor):
        diag_m = (a * a) @ theta_x + diag_extra
    else:
        diag_m = torch.as_tensor(
            a.host.multiply(a.host) @ _host(theta_x),
            device=theta_x.device) + diag_extra

    def mdot(v):
        # [K,-I_s] Theta [K,-I_s]' v already contains the Theta_s slack
        # diagonal, so only reg_d is added here
        return _mv(problem, theta * _rmv(problem, v)) + reg_d * v

    def precond(v):
        return v / torch.clamp_min(diag_m, EPS)

    return lambda rhs_y: pcg(mdot, rhs_y, precond)


def _sparse_newton(problem: IpmProblem, theta_x, diag_extra, reg_d,
                   phase):
    """The "ldl" route: M is built sparse on the host, with a CONSTANT
    pattern across iterations, from the scipy copy of K.  Engines, in
    order: the banded f32 Cholesky on the problem's device (M of at least
    `LARGE_M_ROWS` rows that is banded after RCM, while its refined probe
    solve reaches f64-grade residuals); SuperLU (as many rows; BLAS3
    panels, about 9x faster per factor than the native scalar LDL' on a
    62.5k grid-flow normal matrix in the JAX package's measurement); the
    native LDL' (the rest, and where SuperLU fails)."""
    device = theta_x.device
    key = _pattern_key(problem.a)
    a = problem.a.host
    with phase("normal"):
        aw = a.multiply(_host(theta_x)[None, :]).tocsr()
        mmat = (aw @ a.T + sp.diags(_host(diag_extra))).tocsc()
        mmat.sum_duplicates()
    h = None
    banded = None
    splu = None
    with phase("factor"):
        if mmat.shape[0] >= LARGE_M_ROWS:
            if key not in _BANDED_REJECT and key not in _BANDED_GATED:
                banded = _BANDED_CACHE.get((key, device))
                if banded is None:
                    banded = BandedCholesky.from_spd(mmat, device=device)
                    if banded is None:
                        _BANDED_REJECT.add(key)
                    else:
                        _BANDED_CACHE.clear()
                        _BANDED_CACHE[(key, device)] = banded
            if banded is not None:
                # no exception handler here, unlike the JAX package's:
                # an error on the device propagates, it never turns
                # into a silent hand-off to the host
                banded.factor(mmat)
                # precision gate: the factor is f32, and an
                # ill-conditioned normal matrix (late-IPM Theta swings;
                # flow Laplacians) makes f32 refinement non-contracting.
                # Keep the device route only while a probe solve reaches
                # f64-grade residuals; past that the solve hands off to
                # the host f64 engines for the remaining iterations of
                # this solve (the structure stays cached for the next).
                probe = np.ones(mmat.shape[0])
                px = banded.solve_refined(probe, refine=3)
                pres = np.linalg.norm(mmat @ px - probe) / \
                    np.sqrt(mmat.shape[0])
                if not (np.isfinite(pres) and pres < 1e-6):
                    _BANDED_GATED.add(key)
                    banded = None
            if banded is None:
                try:
                    splu = spla.splu(mmat)
                except RuntimeError:  # exactly singular
                    splu = None
                # a successful but near-singular factor can return
                # huge or NaN columns: probe with a unit solve
                if splu is not None and not np.all(np.isfinite(
                        splu.solve(np.ones(mmat.shape[0])))):
                    splu = None
        if banded is None and splu is None:
            h = _LDL_CACHE.get(key)
            if h is None or not h.matches(mmat):
                # budget ~ 60x the pattern: past that a direct factor
                # loses to iterating, and the ordering cost blows up
                h = SparseLdl(mmat,
                              max_work=80 * mmat.nnz + 1_000_000,
                              max_fill=60 * mmat.nnz + 1_000_000)
                _LDL_CACHE.clear()
                _LDL_CACHE[key] = h
            else:
                h.factor(mmat, reg_floor=max(1e-12, reg_d))

    if banded is not None:
        # the band-matvec refinement runs on the device: each Newton rhs
        # costs one device solve; the host loop below tops it up in f64
        def base(v):
            return banded.solve_refined(v, refine=3)
    else:
        base = splu.solve if splu is not None else h.solve

    def solve_m(rhs_y):
        # iterative refinement: late-IPM normal matrices are extremely
        # ill-conditioned and the dynamic pivot regularization perturbs
        # the factorization (HiPO: KrylovMethods/Refine.cpp)
        rhs = _host(rhs_y)
        x = base(rhs)
        for _ in range(1 if banded is not None else 2):
            x = x + base(rhs - mmat @ x)
        if not np.all(np.isfinite(x)):
            # near-singular factor slipped through: regularize
            # explicitly and retry once
            reg = max(1e-10, reg_d) * (
                1.0 + float(np.abs(mmat.diagonal()).max()))
            hreg = spla.splu((mmat + sp.diags(
                np.full(mmat.shape[0], reg))).tocsc())
            x = hreg.solve(rhs)
            x = x + hreg.solve(rhs - mmat @ x)
        return torch.as_tensor(x, device=device)

    return solve_m


def ipm_step(problem: IpmProblem, state: IpmState, regs,
             settings: Tuple, newton: str = "chol",
             clock: Optional[PhaseClock] = None
             ) -> Tuple[IpmState, IpmMetrics]:
    """One Mehrotra predictor-corrector iteration on the problem's
    device.

    `regs` = (reg_primal, reg_dual), escalated by `solve_lp_ipm_native`
    on a Cholesky breakdown.  `settings` = (sigma_min, sigma_max, ftb,
    theta_max).  `newton` picks the normal-equations solver ("chol",
    "cg" or "ldl", module docstring).  `clock` times the Newton
    phases."""
    def phase(name):
        return clock.phase(name) if clock is not None else \
            contextlib.nullcontext()
    sigma_min, sigma_max, ftb, theta_max = settings
    reg_p, reg_d = float(regs[0]), float(regs[1])
    n = problem.a.shape[1]
    lo_fin, up_fin = problem.lo_fin, problem.up_fin

    rb, rc, rl, ru, _ = _residuals(problem, state)

    n_fin = torch.clamp_min(lo_fin.sum() + up_fin.sum(), 1.0)
    mu = ((state.xl * state.zl * lo_fin).sum() +
          (state.xu * state.zu * up_fin).sum()) / n_fin

    xl_safe = torch.clamp_min(state.xl, EPS)
    xu_safe = torch.clamp_min(state.xu, EPS)
    # diagonal D = Zl/Xl + Zu/Xu + reg; Theta = 1/D, 0 for fixed vars
    d = state.zl / xl_safe * lo_fin + state.zu / xu_safe * up_fin + reg_p
    theta = torch.where(problem.active > 0,
                        torch.clamp(1.0 / d, 0.0, theta_max), 0.0)
    theta_x, theta_s = theta[:n], theta[n:]

    # normal matrix M = K Theta_x K' + Theta_s (ineq diag) + reg_d I
    diag_extra = theta_s * problem.slack_mask + reg_d
    if newton == "ldl":
        solve_m = _sparse_newton(problem, theta_x, diag_extra, reg_d,
                                 phase)
    elif newton == "chol":
        solve_m = _dense_newton(problem, theta_x, diag_extra, phase)
    else:
        solve_m = _cg_newton(problem, theta, theta_x, diag_extra, reg_d)

    def solve_newton(rmu_l, rmu_u):
        rhs_x = (rc - rmu_l / xl_safe * lo_fin -
                 state.zl * rl / xl_safe * lo_fin +
                 rmu_u / xu_safe * up_fin -
                 state.zu * ru / xu_safe * up_fin)
        rhs_y = rb + _mv(problem, theta * rhs_x)
        with phase("solve"):
            dy = solve_m(rhs_y)
        dx = theta * (_rmv(problem, dy) - rhs_x)
        dxl = (dx - rl) * lo_fin
        dxu = (ru - dx) * up_fin
        dzl = ((rmu_l - state.zl * dxl) / xl_safe) * lo_fin
        dzu = ((rmu_u - state.zu * dxu) / xu_safe) * up_fin
        return dx, dy, dxl, dxu, dzl, dzu

    def max_step(v, dv, mask):
        ratio = torch.where((dv < 0) & (mask > 0),
                            -v / torch.clamp_max(dv, -EPS), torch.inf)
        return torch.clamp_max(ratio.min(), 1.0)

    def step_to_boundary(x_parts, z_parts):
        (xl, dxl), (xu, dxu) = x_parts
        (zl, dzl), (zu, dzu) = z_parts
        return (torch.minimum(max_step(xl, dxl, lo_fin),
                              max_step(xu, dxu, up_fin)),
                torch.minimum(max_step(zl, dzl, lo_fin),
                              max_step(zu, dzu, up_fin)))

    # ---- predictor (affine scaling) --------------------------------------
    rmu_l_aff = -state.xl * state.zl * lo_fin
    rmu_u_aff = -state.xu * state.zu * up_fin
    _, _, dxla, dxua, dzla, dzua = solve_newton(rmu_l_aff, rmu_u_aff)
    ap_aff, ad_aff = step_to_boundary(
        ((state.xl, dxla), (state.xu, dxua)),
        ((state.zl, dzla), (state.zu, dzua)))
    mu_aff = (((state.xl + ap_aff * dxla) *
               (state.zl + ad_aff * dzla) * lo_fin).sum() +
              ((state.xu + ap_aff * dxua) *
               (state.zu + ad_aff * dzua) * up_fin).sum()) / n_fin
    sigma = torch.clamp((mu_aff / torch.clamp_min(mu, EPS)) ** 3,
                        sigma_min, sigma_max)

    # ---- corrector (combined) --------------------------------------------
    rmu_l = (sigma * mu - state.xl * state.zl - dxla * dzla) * lo_fin
    rmu_u = (sigma * mu - state.xu * state.zu - dxua * dzua) * up_fin
    dx, dy, dxl, dxu, dzl, dzu = solve_newton(rmu_l, rmu_u)
    alpha_p, alpha_d = step_to_boundary(
        ((state.xl, dxl), (state.xu, dxu)),
        ((state.zl, dzl), (state.zu, dzu)))
    alpha_p = ftb * alpha_p
    alpha_d = ftb * alpha_d

    new_state = IpmState(
        x=state.x + alpha_p * dx,
        xl=torch.where(lo_fin > 0, state.xl + alpha_p * dxl, 1.0),
        xu=torch.where(up_fin > 0, state.xu + alpha_p * dxu, 1.0),
        y=state.y + alpha_d * dy,
        zl=torch.where(lo_fin > 0, state.zl + alpha_d * dzl, 0.0),
        zu=torch.where(up_fin > 0, state.zu + alpha_d * dzu, 0.0))

    # ---- metrics at the new point ----------------------------------------
    rb2, rc2, _, _, c_full = _residuals(problem, new_state)
    mu2 = ((new_state.xl * new_state.zl * lo_fin).sum() +
           (new_state.xu * new_state.zu * up_fin).sum()) / n_fin
    pobj = torch.dot(problem.c, new_state.x[:n])
    lo_safe = torch.where(lo_fin > 0, problem.lo, 0.0)
    up_safe = torch.where(up_fin > 0, problem.up, 0.0)
    # dual objective: b'y + l'zl - u'zu + fixed-var contribution
    fixed_mask = 1.0 - problem.active
    z_fixed = (c_full - _rmv(problem, new_state.y)) * fixed_mask
    dobj = (torch.dot(problem.b, new_state.y) +
            torch.dot(lo_safe, new_state.zl * lo_fin) -
            torch.dot(up_safe, new_state.zu * up_fin) +
            torch.dot(problem.lo * fixed_mask, z_fixed))
    metrics = IpmMetrics(
        primal_res=torch.linalg.norm(rb2), dual_res=torch.linalg.norm(rc2),
        mu=mu2, primal_obj=pobj, dual_obj=dobj,
        alpha_p=alpha_p, alpha_d=alpha_d)
    return new_state, metrics


def starting_point(problem: IpmProblem, solve_gram=None) -> IpmState:
    """Mehrotra-style least-squares starting point (reference analogue:
    ipx ComputeStartingPoint ipm.cc:23 / HiPO starting-point heuristics).

    x0 = argmin ||x||^2 s.t. K_std x = b  (via one Cholesky of K K' + I),
    y0 = argmin ||c - K_std'y||, then shift slacks/duals positive.
    `solve_gram` solves with K K' + diag(slack + 1e-8); by default it is
    formed dense and factored on the problem's device."""
    m, n = problem.a.shape
    lo, up = problem.lo, problem.up
    lo_fin, up_fin = problem.lo_fin, problem.up_fin
    fixed = problem.active <= 0

    if solve_gram is None:
        # Gram matrix of [K, -I_slack]: K K' + slack diag + reg
        chol = cholesky(problem.a @ problem.a.T +
                        torch.diag(problem.slack_mask + 1e-8))

        def solve_gram(rhs):
            return cho_solve(chol, rhs)
    # x0 = K'(KK')^-1 b : minimum-norm solution of K_std x = b
    x0 = _rmv(problem, solve_gram(problem.b))
    # y0 from least squares on the cost: K_std K_std' y = K_std c
    c_full = torch.cat([problem.c, problem.c.new_zeros(m)])
    y0 = solve_gram(_mv(problem, c_full))
    z0 = (c_full - _rmv(problem, y0)) * problem.active

    # shift into the interior (Mehrotra's delta heuristics)
    xl_raw = torch.where(lo_fin > 0, x0 - lo, 1.0)
    xu_raw = torch.where(up_fin > 0, up - x0, 1.0)
    shift_p = torch.clamp_min(-1.5 * torch.minimum(
        torch.where(lo_fin > 0, xl_raw, torch.inf).min(),
        torch.where(up_fin > 0, xu_raw, torch.inf).min()), 0.0) + 0.1
    shift_p = torch.where(torch.isfinite(shift_p), shift_p, 1.0)
    xl0 = torch.where(lo_fin > 0, xl_raw + shift_p, 1.0)
    xu0 = torch.where(up_fin > 0, xu_raw + shift_p, 1.0)

    zl_raw = torch.where(lo_fin > 0, torch.clamp_min(z0, 0.0), 0.0)
    zu_raw = torch.where(up_fin > 0, torch.clamp_min(-z0, 0.0), 0.0)
    shift_d = 0.1 + 0.1 * problem.norm_c / math.sqrt(n + m)
    zl0 = torch.where(lo_fin > 0, zl_raw + shift_d, 0.0)
    zu0 = torch.where(up_fin > 0, zu_raw + shift_d, 0.0)

    x_init = torch.where(fixed, lo, x0)
    return IpmState(x=x_init, xl=xl0, xu=xu0, y=y0, zl=zl0, zu=zu0)


def _host_gram(problem: IpmProblem) -> sp.spmatrix:
    a = problem.a.host
    return a @ a.T + sp.diags(_host(problem.slack_mask) + 1e-8)


def starting_point_sparse(problem: IpmProblem) -> IpmState:
    """The starting point with K K' factored by the native LDL' (host);
    the handle is cached so the first iteration refactors it in place.
    Raises LdlBlowup on a fill-catastrophic pattern."""
    gram = _host_gram(problem).tocsc()
    gram.sum_duplicates()
    h = SparseLdl(gram, max_work=80 * gram.nnz + 1_000_000,
                  max_fill=60 * gram.nnz + 1_000_000)
    _LDL_CACHE.clear()
    _LDL_CACHE[_pattern_key(problem.a)] = h
    return starting_point(problem, solve_gram=lambda r: torch.as_tensor(
        h.solve(_host(r)), device=r.device))


def starting_point_cg(problem: IpmProblem) -> IpmState:
    """The starting point with CG on K K' (sparse, host): the route when
    the direct analysis blows up."""
    gram = _host_gram(problem).tocsr()
    m = gram.shape[0]
    dg = np.maximum(np.asarray(gram.diagonal()), 1e-12)
    pre = spla.LinearOperator((m, m), matvec=lambda v: v / dg)

    def solve_gram(rhs):
        x, _ = spla.cg(gram, _host(rhs), rtol=1e-12, maxiter=500, M=pre)
        return torch.as_tensor(x, device=rhs.device)
    return starting_point(problem, solve_gram=solve_gram)


@dataclasses.dataclass
class IpmRunInfo:
    status: HighsModelStatus = HighsModelStatus.kNotset
    iterations: int = 0
    ipm_iterations: int = 0
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    solve_time: float = 0.0
    newton: str = ""  # the route the iterations ran: chol, cg or ldl


def _geo_scale_dense(mat: np.ndarray, axis: int) -> np.ndarray:
    """Geometric-mean equilibration factors of |mat| along `axis`."""
    amax = mat.max(axis=axis, initial=0.0)
    amin = np.where(mat > 0, mat, np.inf).min(axis=axis, initial=np.inf)
    ok = (amax > 0) & np.isfinite(amin)
    with np.errstate(invalid="ignore"):
        return np.where(ok, 1.0 / np.sqrt(np.where(ok, amax * amin, 1.0)),
                        1.0)


def _geo_scale_sparse(mat_csr: sp.csr_matrix) -> np.ndarray:
    """Geometric-mean equilibration factors of the rows of a CSR matrix."""
    absd = np.abs(mat_csr.data)
    nr = mat_csr.shape[0]
    out = np.ones(nr)
    ptr = mat_csr.indptr
    nz = np.diff(ptr) > 0
    if absd.size:
        amax = np.zeros(nr)
        amin = np.full(nr, np.inf)
        amax[nz] = np.maximum.reduceat(absd, ptr[:-1][nz])
        amin[nz] = np.minimum.reduceat(
            np.where(absd > 0, absd, np.inf), ptr[:-1][nz])
        ok = nz & (amax > 0) & np.isfinite(amin)
        with np.errstate(invalid="ignore"):
            out = np.where(ok, 1.0 / np.sqrt(
                np.where(ok, amax * amin, 1.0)), 1.0)
    return out


def _host_metrics(metrics: IpmMetrics) -> IpmMetrics:
    """The metrics as Python floats, in one device-to-host read."""
    return IpmMetrics(*torch.stack(list(metrics)).cpu().tolist())


def solve_lp_ipm_native(lp: HighsLp, options: HighsOptions, log=None,
                        device=None
                        ) -> Tuple[HighsModelStatus, HighsSolution,
                                   IpmRunInfo]:
    """Solve an LP with the normal-equations IPM on `device` (default
    CUDA).  The iterate lives on the device on every route; unlike the
    JAX package, an LP of at most 1,500 rows stays there too.  The
    "ldl" route factors its Newton systems on the host, as the JAX
    package does, except for its banded factor, which runs on `device`."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    # a precision-gate rejection of the banded factor lasts one solve
    _BANDED_GATED.clear()
    info = IpmRunInfo()
    deadline = getattr(options, "_solve_deadline", None)
    if deadline is not None and time.perf_counter() > deadline:
        info.status = HighsModelStatus.kTimeLimit
        return info.status, HighsSolution(), info
    if lp.num_row == 0:
        status, sol = _solve_bound_lp(lp)
        info.status = status
        if sol.value_valid:
            info.primal_obj = float(lp.col_cost @ sol.col_value) + lp.offset
        return status, sol, info

    std = preprocess_lp(lp)
    m, n_std = std.num_row, std.num_col

    # the route is decided BEFORE materializing K: the sparse-direct
    # route never builds a dense copy
    newton_opt = getattr(options, "tpu_ipm_newton", "choose")
    # a dense copy of K is m x n_std f64: cap the dense working set so a
    # wide (2500 x 5M) or very tall LP never materializes a multi-GB array
    dense_ok = m * max(1, n_std) <= 50_000_000
    if newton_opt in ("cg", "ldl"):
        newton = newton_opt
    elif newton_opt == "cholesky":
        newton = "chol"
    elif m <= 2500 and dense_ok:
        newton = "chol"
    elif m <= 60000:
        newton = "ldl"
    else:
        newton = "cg"
    # "sparse_mode": K is never densified (SparseK); the CG route
    # supports sparse K, so large CG solves never densify either
    sparse_mode = newton == "ldl" or (newton == "cg" and not dense_ok)

    # geometric-mean equilibration for numerical stability
    if sparse_mode:
        a_csr = std.a.tocsr()
        row_s = _geo_scale_sparse(a_csr)
        a_rs = (sp.diags(row_s) @ a_csr).tocsc()
        col_s = _geo_scale_sparse(a_rs.T.tocsr())
        a_scaled = (a_rs @ sp.diags(col_s)).tocsr()
    else:
        a_np = std.a.toarray()
        row_s = _geo_scale_dense(np.abs(a_np), 1)
        col_s = _geo_scale_dense(np.abs(row_s[:, None] * a_np), 0)
        a_scaled = row_s[:, None] * a_np * col_s[None, :]
        del a_np
    b_scaled = row_s * std.b
    c_scaled = std.c * col_s

    # stacked bounds: x~ = x / col_s; surplus slacks s >= 0 on ineq rows
    with np.errstate(invalid="ignore"):
        lo_x = std.col_lower / col_s
        up_x = std.col_upper / col_s
    is_ineq = (np.arange(m) >= std.num_eq).astype(np.float64)
    lo = np.concatenate([lo_x, np.zeros(m)])
    up = np.concatenate([up_x, np.where(is_ineq > 0, np.inf, 0.0)])

    fixed = np.zeros(n_std + m, dtype=bool)
    with np.errstate(invalid="ignore"):
        fixed[:n_std] = np.isfinite(lo_x) & np.isfinite(up_x) & (
            up_x - lo_x <= 1e-14 * (1.0 + np.abs(lo_x)))
    fixed[n_std:] = is_ineq == 0  # eq-row slacks fixed at 0
    big = 1e30

    # analytic-centring mode (reference run_centring, ipx/ipm.cc:450):
    # zero objective + near-unit centering parameter drives the iterate
    # to the analytic centre of the feasible region
    centring = bool(getattr(options, "run_centring", False))
    if centring:
        c_scaled = np.zeros_like(c_scaled)

    def dev(v):
        return torch.as_tensor(v, dtype=F64, device=device)
    problem = IpmProblem(
        a=sparse_k(a_scaled, device) if sparse_mode else dev(a_scaled),
        b=dev(b_scaled), c=dev(c_scaled), slack_mask=dev(is_ineq),
        lo=dev(np.where(np.isfinite(lo), lo, -big)),
        up=dev(np.where(np.isfinite(up), up, big)),
        lo_fin=dev(np.isfinite(lo) & ~fixed),
        up_fin=dev(np.isfinite(up) & ~fixed),
        active=dev(~fixed),
        norm_c=dev(np.linalg.norm(c_scaled)),
        norm_b=dev(np.linalg.norm(b_scaled)))

    time_budget = options.time_limit
    if deadline is not None:
        time_budget = min(time_budget,
                          max(0.0, deadline - time.perf_counter()))
    settings = IpmSettings(
        tolerance=options.ipm_optimality_tolerance,
        iteration_limit=(min(options.max_centring_steps, 300) if centring
                         else min(options.ipm_iteration_limit, 300)),
        time_limit=time_budget)
    sett_tuple = ((0.5, 0.99, settings.fraction_to_boundary,
                   settings.theta_max) if centring else
                  (settings.sigma_min, settings.sigma_max,
                   settings.fraction_to_boundary, settings.theta_max))
    regs = np.array([settings.reg_primal, settings.reg_dual])

    if sparse_mode and newton == "ldl":
        try:
            state = starting_point_sparse(problem)
        except LdlBlowup:
            # fill-catastrophic pattern: matrix-free CG Newton instead
            # (still sparse, still on the host)
            newton = "cg"
            state = starting_point_cg(problem)
    elif sparse_mode:
        state = starting_point_cg(problem)
    else:
        state = starting_point(problem)
    info.newton = newton

    # reading these waits for the starting point
    norm_c_h = float(problem.norm_c)
    norm_b_h = float(problem.norm_b)
    clock = PhaseClock(device)
    t_loop = time.perf_counter()
    it = 0
    status = HighsModelStatus.kNotset
    stall = 0
    best_err = np.inf
    nan_retries = 0
    # user interrupt hook (reference kCallbackIpmInterrupt, fired per
    # IPM iteration — hipo/ipm/Control.cpp:27)
    cbs = getattr(options, "_callbacks", None)
    while it < settings.iteration_limit:
        if cbs is not None and cbs.callback_active(
                _CbT.kCallbackIpmInterrupt):
            cbs.data_out.ipm_iteration_count = it
            if cbs.call(_CbT.kCallbackIpmInterrupt, "IPM interrupt"):
                status = HighsModelStatus.kInterrupt
                break
        prev_state = state
        state, metrics = ipm_step(problem, state, regs, sett_tuple, newton,
                                  clock=clock)
        mh = _host_metrics(metrics)
        clock.collect()
        it += 1
        if not math.isfinite(mh.mu):
            # Cholesky breakdown (degenerate basis as mu -> 0): keep the
            # previous iterate and escalate regularization (reference
            # analogue: HiPO dynamic regularization)
            state = prev_state
            nan_retries += 1
            regs = regs * 100.0
            if nan_retries > 4:
                status = HighsModelStatus.kUnknown
                break
            continue
        rel_p = mh.primal_res / (1.0 + norm_b_h)
        rel_d = mh.dual_res / (1.0 + norm_c_h)
        rel_gap = abs(mh.primal_obj - mh.dual_obj) / (
            1.0 + abs(mh.primal_obj) + abs(mh.dual_obj))
        if log is not None:
            log(f"ipm {it:3d} pobj={mh.primal_obj:.10e} mu={mh.mu:.2e} "
                f"rp={rel_p:.2e} rd={rel_d:.2e} gap={rel_gap:.2e} "
                f"ap={mh.alpha_p:.2f} ad={mh.alpha_d:.2f}")
        err = rel_p + rel_d + rel_gap
        if err < best_err * 0.99:
            best_err = err
            stall = 0
        else:
            stall += 1
        if centring:
            # centring termination: primal feasible and the pairwise
            # products x_i z_i within the centring ratio tolerance
            if rel_p < settings.tolerance and it >= 3:
                prods = torch.cat([state.xl * state.zl,
                                   state.xu * state.zu]).cpu().numpy()
                fin = torch.cat([problem.lo_fin, problem.up_fin]
                                ).cpu().numpy() > 0
                prods = prods[fin]
                prods = prods[prods > 0]
                if len(prods) == 0 or (prods.max() <=
                                       options.centring_ratio_tolerance *
                                       max(prods.min(), 1e-300)):
                    status = HighsModelStatus.kOptimal
                    break
        elif (rel_p < settings.tolerance and rel_d < settings.tolerance
                and rel_gap < settings.tolerance):
            status = HighsModelStatus.kOptimal
            break
        if mh.alpha_p < 1e-8 and mh.alpha_d < 1e-8:
            stall += 5
        if stall > 12:
            status = HighsModelStatus.kUnknown
            break
        if time.perf_counter() - t0 > settings.time_limit:
            status = HighsModelStatus.kTimeLimit
            break
    if status == HighsModelStatus.kNotset:
        status = HighsModelStatus.kIterationLimit
    timer = getattr(options, "_timer", None)
    if timer is not None:
        # the facade's named clocks (getTimer()): host seconds before the
        # first iteration (standard form, scaling, upload, starting
        # point) and of the iterations, and their Newton phases
        timer.add("ipm_setup", t_loop - t0)
        timer.add("ipm_iterations", time.perf_counter() - t_loop, calls=it)
        for name, seconds in clock.seconds.items():
            timer.add(f"ipm_{name}", seconds, calls=it)

    # ---- recover original-space solution ---------------------------------
    xs = state.x.cpu().numpy()
    y_sc = state.y.cpu().numpy()
    # unscale standard-form quantities: x = col_s x~, y = row_s y~,
    # z = z~ / col_s where z~ = c~ - K~'y~
    x_std = xs[:n_std] * col_s
    y_std = y_sc * row_s
    z_std = (c_scaled - (y_sc @ a_scaled)) / col_s

    col_value, row_dual, col_dual = recover_solution(
        std, x_std, y_std, z_std)
    row_value = lp.a_matrix.to_scipy() @ col_value
    sol = HighsSolution(
        value_valid=True, dual_valid=True,
        col_value=col_value, col_dual=col_dual,
        row_value=row_value, row_dual=row_dual)
    info.status = status
    info.iterations = it
    info.ipm_iterations = it
    info.primal_obj = float(lp.col_cost @ col_value) + lp.offset
    info.solve_time = time.perf_counter() - t0
    return status, sol, info
