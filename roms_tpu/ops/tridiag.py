"""Vertical tridiagonal solves, vectorized over all water columns.

The vertical dimension (k, leading axis, N ~ 16-30) is never decomposed
(SURVEY.md §2.2), so these are per-column Thomas solves carried by
lax.scan over k with full (Ny, Nx) planes as the vectorized state, so
every step of the recurrence is one elementwise pass over a plane.

Three solvers, matching the reference numerics exactly:
 * spline_vdiff_flux   - conservative parabolic-spline reconstruction of the
                         vertical derivative used by the implicit viscosity/
                         diffusion steps (step3d_uv.F:346-464 SPLINES_VVISC;
                         step3d_t.F:1036-1090 SPLINES_VDIFF).
 * spline_interp_flux  - parabolic-spline interface interpolation used by
                         SPLINES vertical advection (pre_step3d.F:436-470,
                         step3d_t.F:633-666).
 * thomas_implicit     - standard implicit vertical-diffusion solve
                         (step3d_t.F:1092-1142 non-splines branch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.named_scope("vsolve")
def spline_vdiff_flux(dt: float, Hz, oHz, AK, q):
    """Solve the spline system for interface derivatives of q and return the
    interface flux AK * dq/dz_spline.

    Hz/oHz: (N, ...) layer thickness and inverse (at the q points);
    AK: (N+1, ...) interface mixing coefficient (k=0..N);
    q: (N, ...) field (velocity or tracer).
    Returns DCA: (N+1, ...) with DCA[0]=DCA[N]=0, DCA[k]=AK[k]*D[k].

    System (step3d_uv.F): for k=1..N-1,
      FC(k) = Hz[k]/6   - dt*AK[k-1]*oHz[k]
      CF(k) = Hz[k+1]/6 - dt*AK[k+1]*oHz[k+1]
      BC(k) = (Hz[k]+Hz[k+1])/3 + dt*AK[k]*(oHz[k]+oHz[k+1])
      rhs(k) = q[k+1]-q[k]
    with D(0)=D(N)=0.
    """
    sixth = 1.0 / 6.0
    third = 1.0 / 3.0
    # ROMS k=1..N-1 -> python index kk=0..N-2 between layers kk and kk+1
    FC = sixth * Hz[:-1] - dt * AK[:-2] * oHz[:-1]
    CF = sixth * Hz[1:] - dt * AK[2:] * oHz[1:]
    BC = third * (Hz[:-1] + Hz[1:]) + dt * AK[1:-1] * (oHz[:-1] + oHz[1:])
    rhs = q[1:] - q[:-1]

    zero = jnp.zeros_like(q[0])

    def fwd(carry, xs):
        CFp, DCp = carry
        fc, cf, bc, r = xs
        cff = 1.0 / (bc - fc * CFp)
        CFk = cff * cf
        DCk = cff * (r - fc * DCp)
        return (CFk, DCk), (CFk, DCk)

    (_, _), (CFs, DCs) = jax.lax.scan(fwd, (zero, zero), (FC, CF, BC, rhs))

    def bwd(DCnext, xs):
        CFk, DCk = xs
        DCk = DCk - CFk * DCnext
        return DCk, DCk

    _, Ds = jax.lax.scan(bwd, zero, (CFs, DCs), reverse=True)
    flux = AK[1:-1] * Ds
    return jnp.concatenate([zero[None], flux, zero[None]], axis=0)


@jax.named_scope("vsolve")
def spline_interp_flux(Hz, q, W, c_bot: float, cf1: float,
                       c_top: float, d_top: float):
    """Parabolic-spline interface interpolation of q, multiplied by W.

    Recurrence (pre_step3d.F:436-470 with c_bot=1.5, cf1=0.5, c_top=3,
    d_top=2; step3d_t.F:633-666 with c_bot=2, cf1=1, c_top=2, d_top=1):

      FC(0) = c_bot*q[1];  CF(1) = cf1
      k=1..N-1: cff = 1/(2*Hz[k] + Hz[k+1]*(2-CF(k)))
                CF(k+1) = cff*Hz[k]
                FC(k) = cff*(3*(Hz[k]*q[k+1] + Hz[k+1]*q[k]) - Hz[k+1]*FC(k-1))
      FC(N) = (c_top*q[N] - FC(N-1)) / (d_top - CF(N))
      back:  FC(k) -= CF(k+1)*FC(k+1),  k=N-1..0
    Returns flux (N+1, ...) = W*FC with flux[0]=flux[N]=0.
    """
    N = q.shape[0]
    FC0 = c_bot * q[0]
    CF1 = jnp.full_like(q[0], cf1)

    def fwd(carry, xs):
        CFk, FCm1 = carry
        Hzk, Hzk1, qk, qk1 = xs
        cff = 1.0 / (2.0 * Hzk + Hzk1 * (2.0 - CFk))
        CFk1 = cff * Hzk
        FCk = cff * (3.0 * (Hzk * qk1 + Hzk1 * qk) - Hzk1 * FCm1)
        return (CFk1, FCk), (CFk1, FCk)

    (CF_N, FC_Nm1), (CFs, FCs) = jax.lax.scan(fwd, (CF1, FC0), (Hz[:-1], Hz[1:], q[:-1], q[1:]))
    # CFs[kk] = CF(k+1), FCs[kk] = FC(k) for ROMS k = kk+1 (1..N-1)
    FC_N = (c_top * q[-1] - FC_Nm1) / (d_top - CF_N)

    def bwd(FCnext, xs):
        CFk1, FCk = xs
        FCk = FCk - CFk1 * FCnext
        return FCk, FCk

    _, FCint = jax.lax.scan(bwd, FC_N, (CFs, FCs), reverse=True)
    # interior interfaces k=1..N-1 -> flux = W*FC; ends zero
    zero = jnp.zeros_like(q[0])
    flux = W[1:-1] * FCint
    return jnp.concatenate([zero[None], flux, zero[None]], axis=0)


@jax.named_scope("vsolve")
def thomas_implicit(dt: float, lam: float, Hz, z_r, AK, rhs_mass):
    """Standard implicit vertical diffusion solve (step3d_t.F:1092-1142):

      FC(k) = -dt*lambda*AK[k]/(z_r[k+1]-z_r[k]),  k=1..N-1; FC(0)=FC(N)=0
      BC(k) = Hz[k] - FC(k) - FC(k-1)
      solve tridiag(FC,BC,FC) q = rhs_mass  (rhs in m*Tunits)
    Returns q (N, ...) in Tunits.
    """
    zero = jnp.zeros_like(rhs_mass[0])
    FCi = -dt * lam * AK[1:-1] / (z_r[1:] - z_r[:-1])   # k=1..N-1
    FC = jnp.concatenate([zero[None], FCi, zero[None]], axis=0)  # k=0..N
    BC = Hz - FC[1:] - FC[:-1]

    # forward elimination
    def fwd(carry, xs):
        CFp, DCp = carry
        FCkm1, FCk, BCk, r = xs
        cff = 1.0 / (BCk - FCkm1 * CFp)
        CFk = cff * FCk
        DCk = cff * (r - FCkm1 * DCp)
        return (CFk, DCk), (CFk, DCk)

    (_, _), (CFs, DCs) = jax.lax.scan(fwd, (zero, zero), (FC[:-1], FC[1:], BC, rhs_mass))

    def bwd(qnext, xs):
        CFk, DCk = xs
        qk = DCk - CFk * qnext
        return qk, qk

    _, qs = jax.lax.scan(bwd, zero, (CFs, DCs), reverse=True)
    return qs
