"""Anchor chaining / candidate-interval selection on device.

Batched re-derivation of BLASR's ``FindMaxIncreasingInterval``
(usage: iblasr/BlasrAlignImpl.hpp:170-243): slide a genome window of length
``readLen*(1+indelRate)`` over the t-sorted anchors, compute the best
increasing chain (LIS) inside each window weighted by total anchor bases
(LISSizeWeightor; P-value weightors layered in pipeline/), and emit the top
``nCandidates`` non-overlapping ``WeightedInterval``s plus per-cluster
anchor statistics (ClusterList) for the mapQV significance gate.

Formulated as a single O(A^2) chain DP (a scan of A steps, each an
[B, A]-wide vector max) instead of per-window LIS re-runs: the window
constraint becomes a transition constraint ``t_i - t_j <= wlen``, which
dominates the per-window formulation on a vector machine because every
step is a dense masked max.  Chain start coordinates are carried through
the DP, so no per-chain traceback is needed to produce intervals; parent
pointers are still emitted for the guided-alignment path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from blasr_tpu.kernels.anchor import Anchors

NEG = jnp.float32(-1e30)
BIG = jnp.int32(0x3FFFFFFF)


class Candidates(NamedTuple):
    """Top-nCand candidate intervals per read (WeightedInterval analog)."""

    q_start: jnp.ndarray   # int32 [B, C]
    q_end: jnp.ndarray     # int32 [B, C] (exclusive)
    t_start: jnp.ndarray   # int32 [B, C]
    t_end: jnp.ndarray     # int32 [B, C] (exclusive)
    score: jnp.ndarray     # float32 [B, C] chain weight (anchor bases)
    n_anchors: jnp.ndarray  # int32 [B, C] chain length (ClusterList stat)
    nlogp: jnp.ndarray     # float32 [B, C] chain significance, nats
    #                        (LISSumOfLogPWeightor, BlasrHeaders.h:56)
    valid: jnp.ndarray     # bool [B, C]
    end_idx: jnp.ndarray   # int32 [B, C] index of chain-end anchor in Anchors
    parent: jnp.ndarray    # int32 [B, A] chain parent pointer (-1 = start)


@functools.partial(jax.jit,
                   static_argnames=("n_cand", "rank_by_pvalue", "lookback",
                                    "p_value_type", "global_chain",
                                    "drift_penalty"))
def chain_anchors(
    anchors: Anchors,
    read_len: jnp.ndarray,       # int32 [B]
    *,
    n_cand: int,
    indel_rate: float = 0.3,
    drift_frac: float = 0.35,
    drift_slack: int = 50,
    rank_by_pvalue: bool = False,
    # rank_by_pvalue selects the interval-ranking weightor: False = total
    # anchor bases (LISSizeWeightor), True = chain significance
    # (LISPValueWeightor family, p-value types 0-2; BlasrHeaders.h:54-57)
    p_value_type: int = 0,
    # distinct weightors (iblasr/BlasrHeaders.h:54-57), active when
    # rank_by_pvalue: 0 = tuple-frequency P-value (occurrence-weighted,
    # overlap-scaled), 1 = match-frequency P-value (anchor bases * log 4,
    # genome frequency ignored), 2 = plain sum of per-anchor log P
    # (no overlap scaling)
    lookback: int = 0,
    # transition window: each anchor considers only the lookback most
    # recent (t-sorted) anchors as chain predecessors.  0 = all (the
    # exhaustive default); --fastMaxInterval / --advanceHalf set finite
    # windows (RegisterBlasrOptions.h:172-173, help :331-337: "not as
    # exhaustive as the default, but much faster")
    global_chain: bool = False,
    drift_penalty: float = 0.0,
    # drift_penalty > 0 charges each transition |Δt - Δq| anchor-bases of
    # weight: the guide-extraction pass uses it so a chain cannot hop
    # between tandem-repeat copies for free (each base of diagonal drift
    # implies >= 1 indel in the final alignment).  A REAL structural
    # indel still hops — no same-diagonal continuation exists to beat it
    # — which is the property a hard drift filter would lose.  The
    # reference gets the same discipline from SDPAlign's gap costs in its
    # guide path (BlasrAlignImpl.hpp:780-1004); its candidate RANKING
    # (LIS weightors) has no drift term, so candidate scoring here keeps
    # penalty 0 and only the member/guide pass sets it.
    # --globalChainType >= 1 (RegisterBlasrOptions.h:145, flows into
    # IntervalSearchParameters at BlasrAlignImpl.hpp:105): the interval
    # search chains with RestrictedGlobalChain(..., 0.1, ...) instead of
    # the LIS — successors must start at-or-after the predecessor's END
    # in both coordinates (strict rectangle precedence; overlapping
    # anchors never share a chain) and the diagonal drift is capped at
    # 0.1x the spanned distance (no slack).  Same DP, tighter transition
    # mask — the formulation keeps the masked-max scan either way.
) -> Candidates:
    q, t, l, valid = anchors.q, anchors.t, anchors.l, anchors.valid
    B, A = q.shape
    D = A if lookback <= 0 or lookback > A else lookback
    wlen = (read_len.astype(jnp.float32) * (1.0 + indel_rate)).astype(jnp.int32)

    # S anchors are processed per scan step (sub-steps unrolled in the
    # traced body): the dependency chain over anchors is unchanged — each
    # sub-step sees the in-flight rows of its own block — but the per-step
    # loop/bookkeeping overhead amortizes S-fold.  Identical op order per
    # anchor, so results stay bit-exact vs the S=1 formulation.
    S = 8
    Ap = -(-A // S) * S
    if Ap != A:
        padn = Ap - A

        def pada(x, fill):
            return jnp.concatenate(
                [x, jnp.full((B, padn), fill, x.dtype)], axis=1)

        q, t, l = pada(q, 0), pada(t, 0), pada(l, 0)
        valid = pada(valid, False)
        nlogp_in = pada(anchors.nlogp, 0.0)
    else:
        nlogp_in = anchors.nlogp

    qf = q.astype(jnp.int32)
    tf = t.astype(jnp.int32)

    # DP carries are anchor-major [A+D, B]: each scan step then reads a
    # contiguous [D, B] row window and writes ONE row — a column update
    # of a [B, A+D] array would be a strided scatter across the whole
    # array, while a row update is one contiguous write.
    # Left-padded by D so the predecessor window [i-D, i) is a static-size
    # dynamic slice (anchor j lives at row j+D).
    def padc(x, fill):
        return jnp.concatenate(
            [jnp.full((D, B), fill, x.dtype), x.T], axis=0)

    qfp = padc(qf, -BIG)
    tfp = padc(tf, -BIG)
    vp = padc(valid, False)
    if global_chain:
        # predecessor lengths, windowed like the positions (constant
        # input, not a carry) — the precedence test needs q_j + l_j
        lfp = padc(l.astype(jnp.int32), 0)
        drift_frac, drift_slack = 0.1, 0

    def win(x, i0):
        return jax.lax.dynamic_slice(x, (i0, 0), (D + S, B))

    def row(x, i):
        return jax.lax.dynamic_slice(x, (i, 0), (1, B))[0]

    qT = qf.T         # [Ap, B] anchor-major views of the inputs
    tT = tf.T
    lT = l.T
    vT = valid.T
    pT = nlogp_in.T
    riota = jnp.arange(D + S, dtype=jnp.int32)[:, None]       # [D+S, 1]

    def step(carry, blk):
        best, sq, st, cnt, sump, sumr, parent = carry
        i0 = blk * S
        # block window: rows [i0, i0+D+S) of the padded carries cover the
        # predecessor range of every sub-anchor in the block, including
        # the block's own in-flight rows (anchor i0+s lives at row D+s)
        qj = win(qfp, i0)      # [D+S, B]
        tj = win(tfp, i0)
        vj = win(vp, i0)
        Wb = win(best, i0)
        Wsq, Wst = win(sq, i0), win(st, i0)
        Wcnt = win(cnt, i0)
        Wsump, Wsumr = win(sump, i0), win(sumr, i0)
        par_rows = []
        for s in range(S):
            i = i0 + s
            # transitions j -> i (t-sorted; enforce t_j < t_i explicitly
            # to be safe with ties); rows outside [s, D+s) are other
            # sub-anchors' predecessor windows, masked off
            qi = row(qT, i)        # [B]
            ti = row(tT, i)
            dq = qi[None, :] - qj
            dt = ti[None, :] - tj
            drift = jnp.abs(dt - dq).astype(jnp.float32)
            span = jnp.maximum(dq, dt).astype(jnp.float32)
            ok = (
                vj
                & (riota >= s) & (riota < D + s)
                & row(vT, i)[None, :]
                & (dq > 0)
                & (dt > 0)
                & (dt <= wlen[None, :])
                & (drift <= drift_frac * span + drift_slack)
            )
            if global_chain:
                lj = win(lfp, i0)
                ok &= (dq >= lj) & (dt >= lj)
            # overlap-clipped gain: avoids double counting overlapping
            # anchors
            li = row(lT, i)[None, :].astype(jnp.float32)
            gain = jnp.minimum(li, jnp.minimum(dq, dt).astype(jnp.float32))
            if drift_penalty > 0.0:
                gain = gain - jnp.float32(drift_penalty) * drift
            cand = jnp.where(ok, Wb + gain, NEG)
            w_best = jnp.argmax(cand, axis=0)                 # [B]
            j_best = i0 - D + w_best.astype(jnp.int32)        # absolute index
            v_best = jnp.take_along_axis(cand, w_best[None, :], 0)[0]
            li0 = row(lT, i).astype(jnp.float32)
            start_new = v_best < li0                          # fresh chain
            best_i = jnp.where(start_new, li0, v_best)

            def pick(x, fill):
                return jnp.where(
                    start_new, fill,
                    jnp.take_along_axis(x, w_best[None, :], 0)[0])

            sq_i = pick(Wsq, qi)
            st_i = pick(Wst, ti)
            par_i = jnp.where(start_new, -1, j_best)
            cnt_i = jnp.where(start_new, 1, pick(Wcnt, 0) + 1)
            # significance accumulates scaled by the non-overlapped fraction
            pi = row(pT, i)
            frac = jnp.where(
                start_new, 1.0,
                jnp.take_along_axis(gain, w_best[None, :], 0)[0]
                / jnp.maximum(li0, 1.0))
            sump_i = jnp.where(start_new, pi, pick(Wsump, 0.0) + pi * frac)
            sumr_i = jnp.where(start_new, pi, pick(Wsumr, 0.0) + pi)
            vi = row(vT, i)
            Wb = Wb.at[D + s].set(jnp.where(vi, best_i, NEG))
            Wsq = Wsq.at[D + s].set(sq_i)
            Wst = Wst.at[D + s].set(st_i)
            Wcnt = Wcnt.at[D + s].set(jnp.where(vi, cnt_i, 0))
            Wsump = Wsump.at[D + s].set(jnp.where(vi, sump_i, 0.0))
            Wsumr = Wsumr.at[D + s].set(jnp.where(vi, sumr_i, 0.0))
            par_rows.append(jnp.where(vi, par_i, -1))

        def put(x, w):
            return jax.lax.dynamic_update_slice(x, w[D:D + S], (i0 + D, 0))

        best, sq, st = put(best, Wb), put(sq, Wsq), put(st, Wst)
        cnt = put(cnt, Wcnt)
        sump, sumr = put(sump, Wsump), put(sumr, Wsumr)
        parent = jax.lax.dynamic_update_slice(
            parent, jnp.stack(par_rows), (i0, 0))
        return (best, sq, st, cnt, sump, sumr, parent), None

    def padded(fill, dtype):
        return jnp.full((Ap + D, B), fill, dtype)

    par0 = jnp.full((Ap, B), -1, dtype=jnp.int32)
    (bestp, sqp, stp, cntp, sumpp, sumrp, parentT), _ = jax.lax.scan(
        step,
        (padded(NEG, jnp.float32), padded(0, jnp.int32),
         padded(0, jnp.int32), padded(0, jnp.int32),
         padded(0.0, jnp.float32), padded(0.0, jnp.float32), par0),
        jnp.arange(Ap // S))
    best, sq, st = bestp[D:D + A].T, sqp[D:D + A].T, stp[D:D + A].T
    cnt, sump, sumr = cntp[D:D + A].T, sumpp[D:D + A].T, sumrp[D:D + A].T
    parent = parentT[:A].T

    # select top n_cand chain ends, suppressing ends whose interval overlaps
    # an already-selected one on the genome (nCandidates distinct windows)
    q_end_all = qf[:, :A] + anchors.l
    t_end_all = tf[:, :A] + anchors.l

    if rank_by_pvalue:
        LOG4 = jnp.float32(1.3862944)
        if p_value_type == 1:
            pkey = best * LOG4
        elif p_value_type == 2:
            pkey = sumr
        else:
            pkey = sump
        rank_key = jnp.where(best > NEG * 0.5, pkey, NEG)
    else:
        rank_key = best

    def select(carry, _):
        remaining, = carry
        masked = jnp.where(remaining, rank_key, NEG)
        i_best = jnp.argmax(masked, axis=1)                   # [B]
        v = jnp.take_along_axis(masked, i_best[:, None], 1)[:, 0]
        ok = v > NEG * 0.5
        ts_i = jnp.take_along_axis(st, i_best[:, None], 1)[:, 0]
        te_i = jnp.take_along_axis(t_end_all, i_best[:, None], 1)[:, 0]
        qs_i = jnp.take_along_axis(sq, i_best[:, None], 1)[:, 0]
        qe_i = jnp.take_along_axis(q_end_all, i_best[:, None], 1)[:, 0]
        # suppress chain ends that describe the SAME placement as the
        # selected one: >50% mutual interval overlap AND the same DP
        # diagonal band.  Distinct-diagonal competitors survive — a read
        # spanning several units of a tandem repeat has near-equal
        # placements shifted by the period, and the mapQV partition must
        # see them (PartitionOverlappingAlignments feeds StoreMapQVs,
        # BlasrUtilsImpl.hpp:236-304); same-diagonal near-duplicates
        # would re-derive the identical banded alignment and are pruned
        # here instead of post-DP (RemoveOverlappingAlignments's job,
        # BlasrUtilsImpl.hpp:523-605)
        ov = (jnp.minimum(te_i[:, None], t_end_all)
              - jnp.maximum(ts_i[:, None], st))
        span_min = jnp.minimum((te_i - ts_i)[:, None], t_end_all - st)
        d_sel = (te_i - qe_i)[:, None]
        same_diag = jnp.abs((t_end_all - q_end_all) - d_sel) < 128
        overlap = (2 * ov > span_min) & same_diag
        remaining = remaining & ~overlap
        out = (qs_i, qe_i, ts_i, te_i, v, ok & anchors.valid[jnp.arange(B), i_best],
               i_best.astype(jnp.int32))
        return (remaining,), out

    remaining0 = anchors.valid
    (_,), outs = jax.lax.scan(select, (remaining0,), None, length=n_cand)
    qs, qe, ts, te, sc, okv, endi = [jnp.moveaxis(o, 0, 1) for o in outs]

    n_anch = jnp.take_along_axis(cnt, endi, axis=1)
    chain_p = jnp.take_along_axis(sump, endi, axis=1)

    return Candidates(
        q_start=qs, q_end=qe, t_start=ts, t_end=te,
        score=jnp.where(okv, sc, 0.0),
        n_anchors=jnp.where(okv, n_anch, 0),
        nlogp=jnp.where(okv, chain_p, 0.0),
        valid=okv, end_idx=endi, parent=parent,
    )


@functools.partial(jax.jit, static_argnames=("max_chain",))
def chain_members(candidates: Candidates, anchors: Anchors, *, max_chain: int):
    """Gather (q, t) member anchors of each selected chain, q-ascending,
    padded to max_chain.  Feeds the guided-band center path.

    Member d of a chain is the distance-d ancestor of its end anchor
    under the parent pointers, found by binary lifting: ~log2(max_chain)
    jump-table squarings plus one composition round per bit — ~14
    dependent gather rounds instead of a max_chain-step pointer chase
    (a chase is pure dependent-gather latency)."""
    B, C = candidates.end_idx.shape
    A = anchors.q.shape[1]
    M = max_chain
    nbits = max(1, (M - 1).bit_length())

    def jump(par_b, x):
        # distance doubling with -1 (root) absorbing
        nxt = par_b[jnp.maximum(x, 0)]
        return jnp.where(x < 0, -1, nxt)

    def per_read(end_i, parent_b, q_b, t_b, l_b):
        # end_i: [C] chain ends; member[c, d] = ancestor_at(end_i[c], d)
        d = jnp.arange(M, dtype=jnp.int32)[None, :]      # [1, M]
        cur = jnp.broadcast_to(end_i[:, None], (C, M))   # [C, M]
        par_b2 = parent_b
        for b in range(nbits):
            hop = jump(par_b2, cur)
            cur = jnp.where((d >> b) & 1 == 1, hop, cur)
            if b + 1 < nbits:
                par_b2 = jump(par_b2, par_b2)            # parent^(2^(b+1))
        ok = cur >= 0
        safe = jnp.maximum(cur, 0)
        qs = jnp.where(ok, q_b[safe], BIG)
        ts = jnp.where(ok, t_b[safe], BIG)
        ls = jnp.where(ok, l_b[safe], 0)
        # emitted end-first (q descending); reverse to ascending, pad at end
        order = jnp.argsort(qs, axis=1, stable=True)
        return (jnp.take_along_axis(qs, order, 1),
                jnp.take_along_axis(ts, order, 1),
                jnp.take_along_axis(ls, order, 1))

    mq, mt, ml = jax.vmap(per_read)(candidates.end_idx, candidates.parent,
                                    anchors.q, anchors.t, anchors.l)
    mvalid = mq < BIG
    return mq, mt, ml, mvalid
