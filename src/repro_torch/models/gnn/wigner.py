"""Real-spherical-harmonic Wigner rotation matrices, vectorized over edges.

A torch copy of ``repro.models.gnn.wigner``; the coefficient tables and
the real basis are the reference's numpy, cached per l.

eSCN / EquiformerV2 rotate per-edge irrep features into a frame where the
edge direction is the z-axis, apply an SO(2) convolution (block-diagonal in
m), and rotate back. This module computes the required block-diagonal
Wigner-D matrices D^l(R_e) for real spherical harmonics, l <= l_max, for a
batch of edge directions.

Method: ZYZ Euler decomposition. For edge direction ê with spherical angles
(alpha, beta), R = Ry(-beta) Rz(-alpha) maps ê to ẑ. In the complex SH
basis D^l_{m'm}(a, b, g) = e^{-i m' a} d^l_{m'm}(b) e^{-i m g}; the real
basis is U^l D^l_complex U^l†, which is real up to roundoff. The small-d
matrix uses the explicit Wigner sum with coefficient/power tables
precomputed in numpy per l (k-sum lengths are tiny for l <= 8), evaluated
as vectorized powers of cos(b/2), sin(b/2).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np
import torch

__all__ = ["smalld", "wigner_d_real", "edge_rotations", "rot_mat_zyz"]


@lru_cache(maxsize=None)
def _smalld_tables(l: int):
    """Wigner small-d sum tables for order l.

    Returns (consts [T], out_idx [T], pow_cos [T], pow_sin [T]) where
    d^l_{m'm}(b) = sum_T const * cos(b/2)^pc * sin(b/2)^ps scattered into
    flat (m'+l)*(2l+1) + (m+l).
    """
    consts, out_idx, pcs, pss = [], [], [], []
    dim = 2 * l + 1
    f = math.factorial
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            kmin = max(0, m - mp)
            kmax = min(l + m, l - mp)
            for k in range(kmin, kmax + 1):
                denom = f(l + m - k) * f(k) * f(mp - m + k) * f(l - mp - k)
                c = ((-1) ** (mp - m + k)) * pref / denom
                pc = 2 * l + m - mp - 2 * k
                ps = mp - m + 2 * k
                consts.append(c)
                out_idx.append((mp + l) * dim + (m + l))
                pcs.append(pc)
                pss.append(ps)
    return (np.asarray(consts, np.float64), np.asarray(out_idx, np.int32),
            np.asarray(pcs, np.int32), np.asarray(pss, np.int32))


@lru_cache(maxsize=None)
def _real_basis(l: int) -> np.ndarray:
    """Unitary U^l with Y_real = U^l Y_complex (Condon-Shortley convention).

    Rows indexed by real m_r in [-l..l] (sin|m| for m_r<0, cos m for m_r>0),
    columns by complex m.
    """
    dim = 2 * l + 1
    u = np.zeros((dim, dim), np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            u[i, m + l] = 1j * s2
            u[i, -m + l] = -1j * s2 * (-1) ** m
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, -m + l] = s2
            u[i, m + l] = s2 * (-1) ** m
    return u


def smalld(l: int, beta: torch.Tensor) -> torch.Tensor:
    """Complex-basis small-d matrices d^l(beta): [..., 2l+1, 2l+1]."""
    consts, out_idx, pcs, pss = _smalld_tables(l)
    dim = 2 * l + 1
    dev = beta.device
    c = torch.cos(beta / 2)[..., None]
    s = torch.sin(beta / 2)[..., None]
    # powers 0..2l (integer exponents: a negative base keeps its sign)
    pows = torch.arange(2 * l + 1, device=dev)
    cp = c ** pows
    sp = s ** pows
    pcs_t = torch.as_tensor(pcs, dtype=torch.long, device=dev)
    pss_t = torch.as_tensor(pss, dtype=torch.long, device=dev)
    vals = (torch.as_tensor(consts, dtype=torch.float32, device=dev)
            * cp[..., pcs_t] * sp[..., pss_t])
    # duplicate out_idx entries accumulate (the k-sum)
    flat = vals.new_zeros(beta.shape + (dim * dim,)).index_add_(
        -1, torch.as_tensor(out_idx, dtype=torch.long, device=dev), vals)
    return flat.reshape(beta.shape + (dim, dim))


def wigner_d_real(l: int, alpha: torch.Tensor, beta: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Real-basis Wigner D^l(Rz(alpha) Ry(beta) Rz(gamma)): [..., 2l+1, 2l+1]."""
    dev = alpha.device
    if l == 0:
        return torch.ones(alpha.shape + (1, 1), dtype=torch.float32,
                          device=dev)
    m = torch.arange(-l, l + 1, dtype=torch.float32, device=dev)
    d = smalld(l, beta).to(torch.complex64)
    ea = torch.exp(1j * (alpha[..., None] * m))  # [..., dim] complex64
    eg = torch.exp(1j * (gamma[..., None] * m))
    dc = ea[..., :, None] * d * eg[..., None, :]
    u = torch.as_tensor(_real_basis(l), dtype=torch.complex64, device=dev)
    u_conj = torch.as_tensor(np.conj(_real_basis(l)), dtype=torch.complex64,
                             device=dev)
    dr = torch.einsum("ij,...jk,lk->...il", u, dc, u_conj)
    return dr.real.to(torch.float32)


def edge_rotations(edge_vec: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Per-edge block-diagonal Wigner blocks mapping ê -> ẑ.

    edge_vec [E, 3]. Returns [D^0 .. D^l_max], each [E, 2l+1, 2l+1], for the
    rotation R = Ry(-beta) Rz(-alpha) = ZYZ(0, -beta, -alpha).
    """
    x, y, z = edge_vec[:, 0], edge_vec[:, 1], edge_vec[:, 2]
    r = torch.sqrt(torch.sum(edge_vec ** 2, dim=-1) + 1e-20)
    alpha = torch.atan2(y, x)
    beta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    zero = torch.zeros_like(alpha)
    return [wigner_d_real(l, zero, -beta, -alpha) for l in range(l_max + 1)]


def rot_mat_zyz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """3x3 rotation Rz(alpha) Ry(beta) Rz(gamma) (test utility)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return rz1 @ ry @ rz2
