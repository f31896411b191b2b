"""Sparse dynamic programming (SDP) pairwise alignment on device.

Batched re-derivation of the reference's ``SDPAlign``
(usage: iblasr/BlasrAlignImpl.hpp:902-909,980-990; standalone tool
utils/SDPMatcher.cpp:16-22): k-mer fragments (default sdpTupleSize=11) are
matched between a query and a target window, chained by sparse DP, and the
chain becomes the guide path for banded refinement (the reference's
``detailedSDPAlignment`` between-fragment pass maps to the guided banded
kernel following the fragment path).

All stages are batched over pairs with static shapes:

  * fragment match: per-row target k-mer sort + vectorized searchsorted of
    query k-mers (two [N, L]-wide ops, no per-fragment loops);
  * chain: one masked-max scan over fragments (same O(F^2) vector DP as
    kernels/chain.chain_anchors, all vector work);
  * Global vs Local: Local takes the best chain anywhere; Global anchors
    the alignment to the full query span by extending the chain ends.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from blasr_tpu.kernels.anchor import Anchors, read_kmer_keys
from blasr_tpu.kernels.chain import chain_anchors, chain_members

BIG = jnp.int32(0x3FFFFFFF)


class SDPResult(NamedTuple):
    """Best fragment chain per pair (the SDP alignment skeleton)."""

    q_start: jnp.ndarray   # int32 [N]
    q_end: jnp.ndarray     # int32 [N] exclusive
    t_start: jnp.ndarray   # int32 [N]
    t_end: jnp.ndarray     # int32 [N] exclusive
    score: jnp.ndarray     # float32 [N] chained fragment bases
    n_frags: jnp.ndarray   # int32 [N] fragments in the chain
    valid: jnp.ndarray     # bool [N]
    mq: jnp.ndarray        # int32 [N, max_chain] chain fragment q (BIG pad)
    mt: jnp.ndarray        # int32 [N, max_chain] chain fragment t
    ml: jnp.ndarray        # int32 [N, max_chain] fragment length


@functools.partial(
    jax.jit, static_argnames=("k", "occ_per_pos", "max_frags", "max_chain",
                              "global_align"))
def sdp_align(
    queries: jnp.ndarray,   # int8 [N, Lq]
    qlens: jnp.ndarray,     # int32 [N]
    targets: jnp.ndarray,   # int8 [N, Lt]
    tlens: jnp.ndarray,     # int32 [N]
    *,
    k: int = 11,
    occ_per_pos: int = 4,
    max_frags: int = 1024,
    max_chain: int = 256,
    global_align: bool = True,
) -> SDPResult:
    N, Lq = queries.shape
    Lt = targets.shape[1]
    O = occ_per_pos

    # --- fragment match -------------------------------------------------
    tkeys, tval = read_kmer_keys(targets, tlens, k)          # [N, Lt]
    tkey_m = jnp.where(tval, tkeys, jnp.uint32(0xFFFFFFFF))
    t_order = jnp.argsort(tkey_m, axis=1, stable=True)       # [N, Lt]
    t_sorted = jnp.take_along_axis(tkey_m, t_order, axis=1)

    qkeys, qval = read_kmer_keys(queries, qlens, k)          # [N, Lq]
    lo = jax.vmap(
        lambda ks, qs: jnp.searchsorted(ks, qs, side="left"))(
        t_sorted, qkeys)
    hi = jax.vmap(
        lambda ks, qs: jnp.searchsorted(ks, qs, side="right"))(
        t_sorted, qkeys)
    nocc = (hi - lo).astype(jnp.int32)

    occ = jnp.arange(O, dtype=jnp.int32)
    idx = jnp.clip(lo[:, :, None] + occ[None, None, :], 0, Lt - 1)
    fvalid = qval[:, :, None] & (occ[None, None, :] < nocc[:, :, None])
    t_pos = jnp.take_along_axis(
        t_order, idx.reshape(N, Lq * O), axis=1
    ).reshape(N, Lq, O).astype(jnp.int32)
    q_pos = jax.lax.broadcasted_iota(jnp.int32, (N, Lq, O), 1)

    # top max_frags fragments, deterministic (by q then occurrence)
    flat_q = q_pos.reshape(N, Lq * O)
    flat_t = t_pos.reshape(N, Lq * O)
    flat_v = fvalid.reshape(N, Lq * O)
    rank = jnp.where(flat_v,
                     jax.lax.broadcasted_iota(jnp.int32, (N, Lq * O), 1), BIG)
    order = jnp.argsort(rank, axis=1, stable=True)[:, :max_frags]
    sel_q = jnp.take_along_axis(flat_q, order, axis=1)
    sel_t = jnp.take_along_axis(flat_t, order, axis=1)
    sel_v = jnp.take_along_axis(flat_v, order, axis=1)

    # t-sorted fragment list (chain DP expects t order)
    tkey2 = jnp.where(sel_v, sel_t, BIG)
    order2 = jnp.argsort(tkey2, axis=1, stable=True)
    fq = jnp.take_along_axis(sel_q, order2, axis=1)
    ft = jnp.take_along_axis(sel_t, order2, axis=1)
    fv = jnp.take_along_axis(sel_v, order2, axis=1)

    anchors = Anchors(
        q=fq, t=ft, l=jnp.where(fv, k, 0).astype(jnp.int32), valid=fv,
        n_total=jnp.sum(fv, axis=1).astype(jnp.int32),
        nlogp=jnp.where(fv, float(k), 0.0).astype(jnp.float32))

    # --- chain ----------------------------------------------------------
    # window constraint disabled by passing the full target span as the
    # "read length": SDP chains may span the whole window
    span = jnp.maximum(qlens, tlens)
    cands = chain_anchors(anchors, span, n_cand=1, indel_rate=1.0)
    mq, mt, ml, _ = chain_members(cands, anchors, max_chain=max_chain)
    mq, mt, ml = mq[:, 0], mt[:, 0], ml[:, 0]

    qs = cands.q_start[:, 0]
    qe = cands.q_end[:, 0]
    ts = cands.t_start[:, 0]
    te = cands.t_end[:, 0]
    ok = cands.valid[:, 0]
    if global_align:
        # anchor to the full query: extend the span to the sequence ends
        # along the end diagonals (clamped to the target)
        ts = jnp.maximum(ts - qs, 0)
        te = jnp.minimum(te + (qlens - qe), tlens)
        qs = jnp.zeros_like(qs)
        qe = qlens
    return SDPResult(
        q_start=qs, q_end=qe, t_start=ts, t_end=te,
        score=cands.score[:, 0], n_frags=cands.n_anchors[:, 0],
        valid=ok, mq=mq, mt=mt, ml=ml)


@functools.partial(jax.jit, static_argnames=("k", "occ", "D", "w_b"))
def window_fragment_diags_banded(
    rkeys: jnp.ndarray,    # uint32 [N, L] query k-mer keys (k = sdpTupleSize)
    rvalid: jnp.ndarray,   # bool [N, L]
    windows: jnp.ndarray,  # int8 [N, W] candidate genome windows
    wlens: jnp.ndarray,    # int32 [N]
    offs: jnp.ndarray,     # int32 [N, L] anchors-only band offsets (guide)
    *,
    k: int,
    occ: int,
    D: int = 512,
    w_b: int = 128,
):
    """Diagonal-banded SDP fragment match (between-anchor SDPAlign,
    iblasr/BlasrAlignImpl.hpp:902-909): for every query position, up to
    ``occ`` window positions whose k-mer matches exactly, searched within
    a D-diagonal window centered on the chain-interpolated guide path.

    Rationale: the consumer (_band_offsets) gates fragments to within
    +-band of the flanking chain diagonals anyway, so a diag-local search
    loses nothing it would keep — and it replaces the per-row k-mer sort +
    vmapped binary search (once the two most expensive ops in the
    pipeline) with D static shifted compares.  Ties
    resolve to the lowest diagonal (nearest the path from below), not the
    lowest window position as the sort-based variant did.

    Returns (diag, valid): diag = w_pos - q_pos in window coords,
    [N, L, occ].
    """
    N, L = rkeys.shape
    W = windows.shape[1]
    assert occ in (1, 2), occ
    wkeys, wval = read_kmer_keys(windows, wlens, k)
    INVALID = jnp.uint32(0xFFFFFFFF)
    wkey_m = jnp.where(wval, wkeys, INVALID)

    # per-row diagonal window [dlo, dlo + D): covers the interpolated
    # guide diag range when drift + 2*w_b slack fits in D, else centered
    q = jax.lax.broadcasted_iota(jnp.int32, (N, L), 1)
    diag_c = offs + (w_b // 2) - q                  # interpolated center
    dmin = jnp.min(diag_c, axis=1)
    dmax = jnp.max(diag_c, axis=1)
    dlo = jnp.clip((dmin + dmax) // 2 - D // 2, -(L + D), W)

    # wslice[n, j] = wkey_m[n, dlo_n + j], j in [0, L + D)
    PAD = L + D
    wpad = jnp.concatenate([
        jnp.full((N, PAD), INVALID, jnp.uint32), wkey_m,
        jnp.full((N, PAD), INVALID, jnp.uint32)], axis=1)
    wslice = jax.vmap(
        lambda row, s: jax.lax.dynamic_slice(row, (s,), (L + D)))(
        wpad, dlo + PAD)

    rk_m = jnp.where(rvalid, rkeys, jnp.uint32(0xFFFFFFFE))

    def body(s, carry):
        v0, d0, v1, d1 = carry
        eq = rk_m == jax.lax.dynamic_slice_in_dim(wslice, s, L, axis=1)
        d_s = (dlo + s)[:, None]
        take0 = eq & ~v0
        d0 = jnp.where(take0, jnp.broadcast_to(d_s, d0.shape), d0)
        v0 = v0 | eq
        if occ > 1:
            take1 = eq & ~take0 & ~v1
            d1 = jnp.where(take1, jnp.broadcast_to(d_s, d1.shape), d1)
            v1 = v1 | (eq & ~take0)
        return v0, d0, v1, d1

    z = jnp.zeros((N, L), jnp.int32)
    f = jnp.zeros((N, L), bool)
    v0, d0, v1, d1 = jax.lax.fori_loop(0, D, body, (f, z, f, z))
    if occ == 1:
        return d0[:, :, None], v0[:, :, None]
    return (jnp.stack([d0, d1], axis=2), jnp.stack([v0, v1], axis=2))


@functools.partial(jax.jit, static_argnames=("k", "occ"))
def window_fragment_diags(
    rkeys: jnp.ndarray,    # uint32 [N, L] query k-mer keys (k = sdpTupleSize)
    rvalid: jnp.ndarray,   # bool [N, L]
    windows: jnp.ndarray,  # int8 [N, W] candidate genome windows
    wlens: jnp.ndarray,    # int32 [N]
    *,
    k: int,
    occ: int,
):
    """SDP fragment set in guide form, batched per candidate window: for
    every query position, up to ``occ`` window positions whose k-mer
    matches exactly (the between-anchor SDPAlign fragment match,
    iblasr/BlasrAlignImpl.hpp:902-909, with sdpTupleSize k; --fastSDP
    maps to occ=1).  Returns (diag, valid) with diag = w_pos - q_pos in
    window coordinates, [N, L, occ].  The guide merge in
    pipeline/map_read._band_offsets gates and chains these by flanking
    chain-anchor diagonals, densifying the band path through anchor
    deserts."""
    N, L = rkeys.shape
    W = windows.shape[1]
    wkeys, wval = read_kmer_keys(windows, wlens, k)
    wkey_m = jnp.where(wval, wkeys, jnp.uint32(0xFFFFFFFF))
    w_order = jnp.argsort(wkey_m, axis=1, stable=True)
    w_sorted = jnp.take_along_axis(wkey_m, w_order, axis=1)
    lo = jax.vmap(
        lambda ks, qs: jnp.searchsorted(ks, qs, side="left"))(
        w_sorted, rkeys)
    o = jnp.arange(occ, dtype=jnp.int32)
    idx = jnp.clip(lo[:, :, None] + o[None, None, :], 0, W - 1)
    key_at = jnp.take_along_axis(
        w_sorted, idx.reshape(N, L * occ), axis=1).reshape(N, L, occ)
    wpos = jnp.take_along_axis(
        w_order, idx.reshape(N, L * occ), axis=1
    ).reshape(N, L, occ).astype(jnp.int32)
    v = (rvalid[:, :, None] & (key_at == rkeys[:, :, None])
         & (key_at != jnp.uint32(0xFFFFFFFF)))
    q = jax.lax.broadcasted_iota(jnp.int32, (N, L, occ), 1)
    return wpos - q, v
