"""Shift/average/difference helpers for the staggered Arakawa C-grid.

All fields live on uniformly padded arrays indexed [..., eta(j), xi(i)] with a
halo of ``cfg.halo`` ghost cells on each side.  The padded array covers ROMS
indices ``1-halo .. Lm+halo`` (i.e. the reference's DISTRIBUTE allocation with
NghostPoints=halo; ROMS/Include/tile.h), array index a = roms_i + halo - 1.

Shifts are implemented with jnp.roll, which wraps at the array edge: wrapped
values only land in the halo ring, which is always refreshed by a halo
exchange / boundary fill before being read, exactly as the reference refreshes
ghost points with mp_exchange after each kernel (SURVEY.md §2.2).  Each
stencil application shrinks the valid ring by its radius; validity bookkeeping
follows the reference's exchange points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def take_k(arr, ks):
    """``arr[ks[y,x], ..., y, x]`` — gather along the leading (k) axis.

    Replacement for ``jnp.take_along_axis(arr, ks[None], 0)[0]`` as a
    one-hot masked reduction: one elementwise pass over the field, which
    XLA fuses with its neighbours, instead of a gather.  ``ks`` is
    clipped to the valid range.
    """
    K = arr.shape[0]
    ks = jnp.clip(ks, 0, K - 1)
    karr = jax.lax.broadcasted_iota(jnp.int32, (K,) + ks.shape, 0)
    mask = karr == ks.astype(jnp.int32)[None]
    if arr.ndim > mask.ndim:
        mask = mask.reshape((K,) + (1,) * (arr.ndim - mask.ndim) + ks.shape)
    return jnp.sum(jnp.where(mask, arr, 0), axis=0)


def shift(a, di: int = 0, dj: int = 0):
    """result[..., j, i] = a[..., j+dj, i+di] (wraps in the halo ring)."""
    if di == 0 and dj == 0:
        return a
    shifts, axes = [], []
    if dj != 0:
        shifts.append(-dj)
        axes.append(-2)
    if di != 0:
        shifts.append(-di)
        axes.append(-1)
    return jnp.roll(a, shifts, axes)


# --- neighbor accessors (named after the offset) -------------------------
def ip1(a):
    return shift(a, di=1)


def im1(a):
    return shift(a, di=-1)


def jp1(a):
    return shift(a, dj=1)


def jm1(a):
    return shift(a, dj=-1)


# --- staggered averages ---------------------------------------------------
# Convention (uniform index map): a field at rho(i) averaged "to u(i)" uses
# rho(i-1) and rho(i):  at_u(r)[i] = 0.5*(r[i-1]+r[i]).  Conversely a u-field
# averaged to rho(i) uses u(i) and u(i+1): at_r_from_u(u)[i] = 0.5*(u[i]+u[i+1]).
def at_u(r):
    """rho -> u:  0.5*(r[i-1,j] + r[i,j])."""
    return 0.5 * (im1(r) + r)


def at_v(r):
    """rho -> v:  0.5*(r[i,j-1] + r[i,j])."""
    return 0.5 * (jm1(r) + r)


def at_p(r):
    """rho -> psi: 0.25*(r[i-1,j-1]+r[i,j-1]+r[i-1,j]+r[i,j])."""
    return 0.25 * (r + im1(r) + jm1(r) + shift(r, di=-1, dj=-1))


def u_to_r(u):
    """u -> rho: 0.5*(u[i,j] + u[i+1,j])."""
    return 0.5 * (u + ip1(u))


def v_to_r(v):
    """v -> rho: 0.5*(v[i,j] + v[i,j+1])."""
    return 0.5 * (v + jp1(v))


# --- differences ----------------------------------------------------------
def dxi_r(u_like):
    """xi-difference landing on rho points: d[i] = a[i+1] - a[i] (u->rho)."""
    return ip1(u_like) - u_like


def deta_r(v_like):
    """eta-difference landing on rho points: d[j] = a[j+1] - a[j] (v->rho)."""
    return jp1(v_like) - v_like


def dxi_u(r_like):
    """xi-difference landing on u points: d[i] = a[i] - a[i-1] (rho->u)."""
    return r_like - im1(r_like)


def deta_v(r_like):
    """eta-difference landing on v points: d[j] = a[j] - a[j-1] (rho->v)."""
    return r_like - jm1(r_like)
