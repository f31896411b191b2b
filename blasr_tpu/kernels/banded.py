"""Guided banded affine alignment — the framework's hottest kernel.

One wavefront-banded affine DP serves the roles of the reference's
``KBandAlign`` / ``AffineKBandAlign`` / ``GuidedAlign`` / ``AffineGuidedAlign``
(usage: iblasr/BlasrAlignImpl.hpp:1227-1309, BlasrUtilsImpl.hpp:620-903):
the band follows a *guide path* (the anchor chain, standing in for the
reference's SDP fragment path), scores minimize (match -5 / mismatch 6 /
asymmetric indels, iblasr/RegisterBlasrOptions.h:350-360 semantics), and a
2-bit-per-state traceback is stored per banded cell.

Mapping onto the device (this module is the plain-JAX version and the
reference; kernels/banded_cuda.py runs the same forward pass as a CUDA
kernel on GPUs):
  * rows = query positions, processed by one ``lax.scan``; each step is a
    fixed 128-lane band vector of elementwise work, vmapped over a
    flattened [reads x candidates] batch so every step is [N, 128].
  * the in-row deletion recurrence D[w] = min(D[w-1]+ext, base[w-1]+open)
    is solved in closed form with a prefix cummin
    (D = ext*w + cummin(base - ext*w') + open), avoiding a sequential
    lane walk.
  * band offsets shift per row along the guide path; shifts are realized
    with dynamic slices of 1-padded carries, so arbitrary per-row target
    jumps (deletion bursts between anchors) stay within the recurrence.
  * traceback is a second ``lax.scan`` over stored per-cell bits; its
    output op-string feeds CIGAR/stat building.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# All costs are integer-valued; f32 arithmetic on integers < 2^24 is exact,
# so comparisons (tie detection for traceback bits) are bit-stable on any
# backend and in any summation order, while keeping fast f32 vector math.
INF = jnp.float32(1e30)

# traceback cell word layout (int32 per banded cell)
#   bits 0-1: source state of M's diagonal predecessor (0=M, 1=I, 2=D)
#   bit 2   : I opened from M (else extended from I)
#   bit 3   : D opened at this cell (else extended from D[w-1])
#   bit 4   : D opened from M (else from I)
#   bit 5   : read base == target base at this cell
#   bit 6   : h_open (homopolymer-insertion band opened from M)
#   bits 7-8:  run-exit state — m_src at the start of this cell's M run
#   bits 9-14: M-run length (consecutive state-M cells chained by
#              m_src==M diagonal links, capped at RUN_CAP; the traceback
#              consumes a whole run per step)
#   bits 15-20: eq count within the run (matches; run length minus this
#              is the mismatch count)
#   bits 21-22: s_r — this row's band shift offsets[r]-offsets[r-1]
#              (0 at the first active row; REQUIRES slope-limited
#              offsets, the _band_offsets contract)
#   bits 23-29: ssum — sum of s over the M-run's rows (<= 2*RUN_CAP)
# s_r/ssum let the traceback walk band coordinates directly: one cell
# gather per step instead of a cell gather + a dependent offsets gather
# (the pointer chase is the step's whole cost).
ST_M, ST_I, ST_D = 0, 1, 2
ST_H = 3  # homopolymer-insertion state (affine hp band; bit 6 = h_open)
RUN_CAP = 63  # 6-bit run fields; longer runs chain in segments


class BandedResult(NamedTuple):
    score: jnp.ndarray        # float32 [N] (integer-valued)
    tbbits: jnp.ndarray       # int32 [N, L, W_b] cell words (layout above)
    final_state: jnp.ndarray  # int32 [N]
    valid: jnp.ndarray        # bool [N] alignment reached the end cell


class TracebackResult(NamedTuple):
    """Run-length traceback: (op, count) pairs emitted end-first.

    Each pair is op | count << 2 (op: 0 stop, 1 M columns — matches and
    mismatches, 2 insertion bases, 3 deletion bases), packed two per
    int32 word (low half first).  A whole M run is one pair, so pairs
    scale with the error count, not the read length."""

    pairs: jnp.ndarray        # int32 [N, P//2] packed (op|count<<2) x2
    n_pairs: jnp.ndarray      # int32 [N]
    n_match: jnp.ndarray      # int32 [N]
    n_mismatch: jnp.ndarray   # int32 [N]
    n_ins: jnp.ndarray        # int32 [N]
    n_del: jnp.ndarray        # int32 [N]
    overflow: jnp.ndarray     # bool [N]: > P pairs needed (caller reruns
    #                           with the dense bound t_max = L + W)


def _shift(padded_row: jnp.ndarray, k: jnp.ndarray, w_b: int) -> jnp.ndarray:
    """out[w] = row[w + k] where padded_row = [fill, row, fill*w_b], k >= -1."""
    return jax.lax.dynamic_slice(padded_row, (k + 1,), (w_b,))


def _pad_row(row: jnp.ndarray, fill) -> jnp.ndarray:
    w_b = row.shape[0]
    return jnp.concatenate(
        [jnp.full((1,), fill, row.dtype), row, jnp.full((w_b,), fill, row.dtype)])


def _align_one(
    read, window, offsets, qa, qb, ta, tb,
    submat, ins_open, ins_ext, del_open, del_ext, w_b,
    hp_open=None, hp_ext=None, qv1=None, qv2=None,
):
    use_hp = hp_open is not None
    use_qv = qv1 is not None
    """Forward DP for one read x one target window.

    read:    int8 [L]     query codes
    window:  int8 [W]     target window codes (already sliced from genome)
    offsets: int32 [L]    band start (window coord) per query row, monotone
    qa, qb:  int32        aligned query range [qa, qb)
    ta, tb:  int32        aligned window range [ta, tb)  (window coords)

    QV-steered mode (qv1/qv2 given): the DP costs come from per-row QV
    tracks instead of flat gap penalties — the reference's KBandAlign
    with an IDS/QualityValue score function (PairwiseLocalAlign QV
    branch, iblasr/BlasrAlignImpl.hpp:1276-1298; IDS semantics
    BlasrHeaders.h:51-52): insertionQV prices an inserted query base,
    deletionQV of the neighboring query base prices deleting a target
    base whose identity matches the read's DeletionTag (else the global
    deletion prior), substitutionQV prices a mismatch whose target base
    matches the SubstitutionTag (else the substitution prior).  Gaps are
    linear (open == extend), matching KBandAlign.  Packed layout:
      qv1[j]: insQV | delQV<<8 | subQV<<16 | dtag<<24 | stag<<27
      qv2[j]: delPrior | subPrior<<8
    (8-bit costs; tag code 7 = "never matches" so per-row fallbacks to
    the prior fields express missing tracks exactly.)
    """
    L = read.shape[0]
    W = window.shape[0]
    wpad = jnp.concatenate([window, jnp.full((w_b,), 4, dtype=window.dtype)])
    if use_qv:
        insq = (qv1 & 255).astype(jnp.float32)
        delq = ((qv1 >> 8) & 255).astype(jnp.float32)
        subq = ((qv1 >> 16) & 255).astype(jnp.float32)
        dtagv = (qv1 >> 24) & 7
        stagv = (qv1 >> 27) & 7
        dpri = (qv2 & 255).astype(jnp.float32)
        spri = ((qv2 >> 8) & 255).astype(jnp.float32)
        # leading-deletion boundary profile uses row qa's deletion costs
        # (the first query neighbor); prefix sums make it band-sliceable
        dq0 = jnp.take(delq, qa)
        dt0 = jnp.take(dtagv, qa)
        dp0 = jnp.take(dpri, qa)
        c0 = jnp.where(window.astype(jnp.int32) == dt0, dq0, dp0)
        cumz = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                                jnp.cumsum(c0)])  # [W+1]
        cumz_ta = jnp.take(cumz, ta)

    # cell (r, w) == "consumed read[qa..r] and window[ta..o_r+w]"; the
    # boundary (virtual row qa-1) therefore has its zero-cost M cell at
    # t_abs == ta-1 and leading-deletion D costs open+ext*(t-ta) at t >= ta.
    # Callers must guarantee ta >= 1 so the boundary cell is addressable.
    def boundary(o_r):
        t_abs = o_r + jnp.arange(w_b, dtype=jnp.int32)
        if use_qv:
            cg = jnp.take(cumz, jnp.clip(t_abs + 1, 0, W))
            prof = jnp.where(t_abs >= ta, cg - cumz_ta, INF)
        else:
            d = (t_abs - ta).astype(jnp.float32)
            prof = jnp.where(t_abs >= ta, del_open + del_ext * d, INF)
        m0 = jnp.where(t_abs == ta - 1, 0.0, INF)
        return m0, jnp.full((w_b,), INF), prof, jnp.full((w_b,), INF)

    def step(carry, r):
        (pM, pI, pD, pH, pR, pE, pX, pS, po,
         fin_score, fin_state, fin_ok) = carry
        o_r = offsets[r]
        active = (r >= qa) & (r < qb)
        first = r == qa

        bM, bI, bD, bH = boundary(o_r)
        pM_, pI_, pD_, pH_ = (
            jnp.where(first, bM, pM),
            jnp.where(first, bI, pI),
            jnp.where(first, bD, pD),
            jnp.where(first, bH, pH),
        )
        s = jnp.where(first, 0, o_r - po)

        pMp, pIp, pDp = _pad_row(pM_, INF), _pad_row(pI_, INF), _pad_row(pD_, INF)
        dM, dI, dD = (_shift(pMp, s - 1, w_b), _shift(pIp, s - 1, w_b),
                      _shift(pDp, s - 1, w_b))
        # M-run counters of the diagonal predecessor
        dR = _shift(_pad_row(pR, 0), s - 1, w_b)
        dE = _shift(_pad_row(pE, 0), s - 1, w_b)
        dX = _shift(_pad_row(pX, 0), s - 1, w_b)
        dS = _shift(_pad_row(pS, 0), s - 1, w_b)
        vM, vI = _shift(pMp, s, w_b), _shift(pIp, s, w_b)
        if use_hp:
            pHp = _pad_row(pH_, INF)
            dH = _shift(pHp, s - 1, w_b)
            vH = _shift(pHp, s, w_b)

        t_abs = o_r + jnp.arange(w_b, dtype=jnp.int32)
        in_t = (t_abs >= ta) & (t_abs < tb)
        # I consumes no target base, so it is also valid at column ta-1
        # (insertions before the first target base)
        in_t_i = (t_abs >= ta - 1) & (t_abs < tb)
        tgt = jax.lax.dynamic_slice(wpad, (jnp.maximum(o_r, 0),), (w_b,))
        rb = read[r].astype(jnp.int32)
        tgt_i = tgt.astype(jnp.int32)
        sub = submat[rb * 5 + tgt_i]
        eq = (rb == tgt_i) & (rb < 4)
        if use_qv:
            # mismatch: substitutionQV where the target base matches the
            # SubstitutionTag, else the per-row prior (IDS Match)
            sub = jnp.where(eq, sub,
                            jnp.where(tgt_i == stagv[r], subq[r], spri[r]))

        diag_best = jnp.minimum(dM, jnp.minimum(dI, dD))
        if use_hp:
            diag_best = jnp.minimum(diag_best, dH)
            m_src = jnp.where(
                dM <= diag_best, ST_M,
                jnp.where(dI <= diag_best, ST_I,
                          jnp.where(dD <= diag_best, ST_D,
                                    ST_H))).astype(jnp.int32)
        else:
            m_src = jnp.where(
                dM <= diag_best, ST_M,
                jnp.where(dI <= diag_best, ST_I, ST_D)).astype(jnp.int32)
        M = jnp.where(in_t, sub + diag_best, INF)

        if use_qv:
            # insertionQV prices this inserted query base (linear gap)
            i_from_m = vM + insq[r]
            i_from_i = vI + insq[r]
        else:
            i_from_m = vM + ins_open
            i_from_i = vI + ins_ext
        I = jnp.where(in_t_i, jnp.minimum(i_from_m, i_from_i), INF)
        i_open = i_from_m <= i_from_i

        if use_hp:
            # homopolymer-insertion band (AffineKBandAlign's hpIns track,
            # BlasrAlignImpl.hpp:1262-1266): an inserted base equal to
            # the previous read base opens/extends at hp costs
            rprev = jnp.where(r > 0, read[jnp.maximum(r - 1, 0)].astype(
                jnp.int32), 4)
            hp_ok = (read[r].astype(jnp.int32) == rprev) & (rprev < 4)
            h_from_m = vM + hp_open
            h_from_h = vH + hp_ext
            H = jnp.where(in_t_i & hp_ok,
                          jnp.minimum(h_from_m, h_from_h), INF)
            h_open_bit = h_from_m <= h_from_h
            base = jnp.minimum(jnp.minimum(M, I), H)
        else:
            H = pH_
            h_open_bit = jnp.zeros((w_b,), bool)
            base = jnp.minimum(M, I)
        w_idx = jnp.arange(w_b, dtype=jnp.float32)
        if use_qv:
            # per-cell deletion cost: deletionQV where the deleted target
            # base matches the DeletionTag, else the per-row prior (IDS
            # Deletion); linear gaps, so the prefix-cummin closed form
            # uses the cost cumsum instead of ext*w
            cd = jnp.where(tgt_i == dtagv[r], delq[r], dpri[r])
            S = jnp.cumsum(cd)
            g = jnp.where(base < INF * 0.5, base - S, INF)
            run = jax.lax.cummin(g)
            run_prev = jnp.concatenate([jnp.full((1,), INF), run[:-1]])
            # D[w] = base[w'] + sum cd[w'+1..w] over w' < w
            D = jnp.where(in_t, S + run_prev, INF)
            D = jnp.minimum(D, INF)
            base_prev = jnp.concatenate([jnp.full((1,), INF), base[:-1]])
            d_open = D >= base_prev + cd
        else:
            g = jnp.where(base < INF * 0.5, base - del_ext * w_idx, INF)
            run = jax.lax.cummin(g)
            run_prev = jnp.concatenate([jnp.full((1,), INF), run[:-1]])
            # D[w] = open + ext*(w - w' - 1) + base[w'] over w' < w
            D = jnp.where(
                in_t, del_ext * w_idx + run_prev + (del_open - del_ext), INF)
            D = jnp.minimum(D, INF)
            base_prev = jnp.concatenate([jnp.full((1,), INF), base[:-1]])
            # D <= base_prev+open always holds (D is the min), so the
            # open/extend bit must test >=: true iff opening at w-1
            # achieves the min
            d_open = D >= base_prev + del_open
        M_prev = jnp.concatenate([jnp.full((1,), INF), M[:-1]])
        I_prev = jnp.concatenate([jnp.full((1,), INF), I[:-1]])
        d_from_m = M_prev <= I_prev

        # M-run counters for this cell (see cell-word layout above):
        # a fresh run starts when the diag link is not M-to-M, at the
        # first row (diag predecessor is the boundary), or at RUN_CAP
        msrc_i = m_src.astype(jnp.int32)
        from_m = msrc_i == ST_M
        fresh = (~from_m) | first | (dR >= RUN_CAP)
        eq_i = eq.astype(jnp.int32)
        mrun = jnp.where(fresh, 1, dR + 1)
        meq = jnp.where(fresh, 0, dE) + eq_i
        rexit = jnp.where(fresh, jnp.where(from_m, ST_M, msrc_i), dX)
        # saturate on offset jumps (slope > 2): s_r = 3 / ssum = 127 flag
        # the traceback to re-derive w from offsets with a stall step
        s_clip = jnp.minimum(s, 3)
        ssum = jnp.where(s > 2, 127,
                         jnp.minimum(jnp.where(fresh, s, dS + s), 127))

        bits = (
            msrc_i
            | (i_open.astype(jnp.int32) << 2)
            | (d_open.astype(jnp.int32) << 3)
            | (d_from_m.astype(jnp.int32) << 4)
            | (eq_i << 5)
            | (h_open_bit.astype(jnp.int32) << 6)
            | (rexit << 7)
            | (mrun << 9)
            | (meq << 15)
            | (s_clip << 21)
            | (ssum << 23)
        )
        bits = jnp.where(active, bits, jnp.int32(0))

        nM = jnp.where(active, M, pM)
        nI = jnp.where(active, I, pI)
        nD = jnp.where(active, D, pD)
        nH = jnp.where(active, H, pH)
        nR = jnp.where(active, mrun, pR)
        nE = jnp.where(active, meq, pE)
        nX = jnp.where(active, rexit, pX)
        nS = jnp.where(active, ssum, pS)
        no = jnp.where(active, o_r, po)

        # record final score at row qb-1, cell t = tb-1
        is_last = r == qb - 1
        wf = tb - 1 - o_r
        ok_wf = (wf >= 0) & (wf < w_b)
        wf_c = jnp.clip(wf, 0, w_b - 1)
        cM, cI, cD = M[wf_c], I[wf_c], D[wf_c]
        cbest = jnp.minimum(cM, jnp.minimum(cI, cD))
        if use_hp:
            cH = H[wf_c]
            cbest = jnp.minimum(cbest, cH)
            cstate = jnp.where(cM <= cbest, ST_M,
                               jnp.where(cI <= cbest, ST_I,
                                         jnp.where(cD <= cbest, ST_D, ST_H)))
        else:
            cstate = jnp.where(cM <= cbest, ST_M,
                               jnp.where(cI <= cbest, ST_I, ST_D))
        hit = is_last & active & ok_wf & (cbest < INF * 0.5)
        fin_score = jnp.where(hit, cbest, fin_score)
        fin_state = jnp.where(hit, cstate, fin_state)
        fin_ok = fin_ok | hit

        return (nM, nI, nD, nH, nR, nE, nX, nS, no,
                fin_score, fin_state, fin_ok), bits

    zi = jnp.zeros((w_b,), jnp.int32)
    carry0 = (
        jnp.full((w_b,), INF), jnp.full((w_b,), INF), jnp.full((w_b,), INF),
        jnp.full((w_b,), INF), zi, zi, zi, zi,
        jnp.int32(0), INF, jnp.int32(ST_M), jnp.bool_(False),
    )
    (*_, score, state, ok), tbbits = jax.lax.scan(
        step, carry0, jnp.arange(L, dtype=jnp.int32))
    return score, tbbits, state, ok


@functools.partial(jax.jit, static_argnames=("w_b", "use_hp"))
def banded_align(
    reads, windows, offsets, qa, qb, ta, tb, submat,
    ins_open, ins_ext, del_open, del_ext, *, w_b: int = 128,
    use_hp: bool = False, hp_open=0.0, hp_ext=0.0,
    qv1=None, qv2=None,
) -> BandedResult:
    """Batched guided banded alignment.

    reads   int8  [N, L]
    windows int8  [N, W]
    offsets int32 [N, L]   band start per row (window coordinates)
    qa..tb  int32 [N]      global alignment ranges (window coords for t)
    submat  float32 [25]   flattened 5x5 score matrix (integer-valued)
    qv1/qv2 int32 [N, L]   packed per-row QV costs (QV-steered mode; see
                           _align_one) — mutually exclusive with use_hp
    """
    # integer-valued costs in f32 (exact below 2^24)
    submat = jnp.asarray(submat, jnp.float32)
    ins_open = jnp.asarray(ins_open, jnp.float32)
    ins_ext = jnp.asarray(ins_ext, jnp.float32)
    del_open = jnp.asarray(del_open, jnp.float32)
    del_ext = jnp.asarray(del_ext, jnp.float32)
    if qv1 is not None:
        assert not use_hp, "QV-steered DP uses linear gaps (no hp band)"
        f = jax.vmap(
            _align_one,
            in_axes=(0, 0, 0, 0, 0, 0, 0, None, None, None, None, None,
                     None, None, None, 0, 0),
        )
        score, tbbits, state, ok = f(
            reads, windows, offsets, qa, qb, ta, tb,
            submat, ins_open, ins_ext, del_open, del_ext, w_b,
            None, None, qv1, qv2)
    elif use_hp:
        f = jax.vmap(
            _align_one,
            in_axes=(0, 0, 0, 0, 0, 0, 0, None, None, None, None, None,
                     None, None, None),
        )
        score, tbbits, state, ok = f(
            reads, windows, offsets, qa, qb, ta, tb,
            submat, ins_open, ins_ext, del_open, del_ext, w_b,
            jnp.asarray(hp_open, jnp.float32),
            jnp.asarray(hp_ext, jnp.float32))
    else:
        f = jax.vmap(
            _align_one,
            in_axes=(0, 0, 0, 0, 0, 0, 0, None, None, None, None, None,
                     None),
        )
        score, tbbits, state, ok = f(
            reads, windows, offsets, qa, qb, ta, tb,
            submat, ins_open, ins_ext, del_open, del_ext, w_b)
    return BandedResult(score, tbbits, state.astype(jnp.int32), ok)


def slope_limit_offsets(offs: jnp.ndarray) -> jnp.ndarray:
    """Clamp band offsets int32 [..., L] to a monotone path advancing 0, 1
    or 2 per row (the CUDA kernel's shift contract).  The recurrence
    o'[r] = min(o[r], o'[r-1] + 2) over the running max o unrolls to the
    closed form 2r + cummin(o - 2r) (exact ints)."""
    ax = offs.ndim - 1
    r = jnp.arange(offs.shape[ax], dtype=jnp.int32)
    offs = jax.lax.cummax(offs, axis=ax)
    return 2 * r + jax.lax.cummin(offs - 2 * r, axis=ax)


_TB_CHUNK = 64   # RL steps per while_loop iteration
_CNT_CAP = 16383  # 14-bit pair count (boundary-deletion runs re-loop)


@functools.partial(jax.jit, static_argnames=("t_max", "w_b"))
def banded_traceback(
    result: BandedResult, offsets, qa, qb, ta, tb, *, t_max: int, w_b: int = 128,
) -> TracebackResult:
    """Run-length traceback over the cell words.

    One RL step consumes a whole M run (via the in-cell run counters), a
    single I/D base, or a whole leading-deletion boundary run, so typical
    alignments finish in ~2x(indel events) steps instead of one step per
    alignment column.  A chunked while_loop exits once every row is done;
    ``t_max`` bounds the emitted pairs (and steps).  Rows needing more
    pairs report ``overflow`` and callers rerun with t_max = L + W, which
    can never overflow (every pair consumes >= 1 column)."""
    tbb = result.tbbits
    N, L, _ = tbb.shape
    flat = tbb.reshape(N, L * w_b)
    P = -(-t_max // (2 * _TB_CHUNK)) * (2 * _TB_CHUNK)

    def rl_step(carry, _):
        r, t, w, wbad, st, done, nm, nmm, nins, ndel, npairs = carry
        at_b = r < qa
        rc = jnp.clip(r, 0, L - 1)
        # band coordinates are carried (updated from the in-cell s_r/ssum
        # fields): the cell gather per step has no dependent offsets
        # gather in front of it.  The offsets gather below is issued IN
        # PARALLEL (depends only on the carry) and is consumed only by
        # stall steps (wbad: the previous transition crossed a saturated
        # offset jump, s_r == 3 / ssum == 127) which re-derive w and emit
        # a zero-count no-op pair.
        off_rc = jnp.take_along_axis(offsets, rc[:, None], axis=1)[:, 0]
        w_ok = (w >= 0) & (w < w_b)
        idx = rc * w_b + jnp.clip(w, 0, w_b - 1)
        cell = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        i_open = (cell >> 2) & 1
        d_open = (cell >> 3) & 1
        d_from_m = (cell >> 4) & 1
        h_open = (cell >> 6) & 1
        rexit = (cell >> 7) & 3
        # max(.,1) guards corrupt zero-run cells (can only appear off the
        # valid path): guarantees progress toward the step bound
        mrun = jnp.maximum((cell >> 9) & 63, 1)
        meq = (cell >> 15) & 63
        s_r = (cell >> 21) & 3
        ssum = (cell >> 23) & 127

        b_more = at_b & (t >= ta)
        b_done = at_b & (t < ta)
        stall = wbad & ~done & ~at_b
        is_m = (~at_b) & (st == ST_M) & ~stall
        is_i = (~at_b) & ((st == ST_I) | (st == ST_H)) & ~stall
        is_d = (~at_b) & (st == ST_D) & ~stall
        emit = ~(done | b_done | stall)

        b_cnt = jnp.minimum(t - ta + 1, _CNT_CAP)
        # stall steps emit op=1 count=0 (a no-op every decoder skips) so
        # the positional pair stream carries no mid-stream stop words
        op = jnp.where(stall, 1,
             jnp.where(~emit, 0,
             jnp.where(b_more, 3,
             jnp.where(is_m, 1,
             jnp.where(is_i, 2, 3)))))
        cnt = jnp.where(stall, 0,
              jnp.where(b_more, b_cnt,
              jnp.where(is_m, mrun, 1)))
        pair = jnp.where(emit | stall, op | (cnt << 2), 0)

        nr = jnp.where(emit & (is_m | is_i),
                       r - jnp.where(is_m, mrun, 1), r)
        nt = jnp.where(emit,
                       t - jnp.where(b_more, b_cnt,
                           jnp.where(is_m, mrun,
                           jnp.where(is_d, 1, 0))), t)
        # w' = t' - offsets[r']: M run lands ssum band columns right of
        # w - mrun; I climbs one row (shift s_r); D walks one lane left
        nw = jnp.where(stall, t - off_rc,
             jnp.where(emit,
                       jnp.where(is_m, w - mrun + ssum,
                       jnp.where(is_i, w + s_r,
                       jnp.where(is_d, w - 1, w))), w))
        sat = (is_i & (s_r == 3)) | (is_m & (ssum == 127))
        nwbad = jnp.where(stall, False,
                          wbad | (emit & sat & (nr >= qa)))
        is_h = (~at_b) & (st == ST_H) & ~stall
        nst = jnp.where(is_m, rexit,
              jnp.where(is_h, jnp.where(h_open == 1, ST_M, ST_H),
              jnp.where(is_i, jnp.where(i_open == 1, ST_M, ST_I),
              jnp.where(is_d,
                        jnp.where(d_open == 1,
                                  jnp.where(d_from_m == 1, ST_M, ST_I),
                                  ST_D),
                        st))))
        nm = nm + jnp.where(emit & is_m, meq, 0)
        nmm = nmm + jnp.where(emit & is_m, mrun - meq, 0)
        nins = nins + jnp.where(emit & is_i, 1, 0)
        ndel = ndel + jnp.where(emit & is_d, 1, 0) \
            + jnp.where(emit & b_more, b_cnt, 0)
        npairs = npairs + emit.astype(jnp.int32)
        ndone = done | b_done | ((~at_b) & ~w_ok & emit)
        return (nr, nt, nw, nwbad, nst, ndone,
                nm, nmm, nins, ndel, npairs), pair

    z = jnp.zeros((N,), jnp.int32)

    def chunk_cond(state):
        s0, carry, buf = state
        return (s0 < P) & jnp.any(~carry[5])

    def chunk_body(state):
        s0, carry, buf = state
        carry, pairs = jax.lax.scan(rl_step, carry, None, length=_TB_CHUNK)
        buf = jax.lax.dynamic_update_slice(buf, pairs.T, (0, s0))
        return s0 + _TB_CHUNK, carry, buf

    off_last = jnp.take_along_axis(
        offsets, jnp.clip(qb - 1, 0, L - 1)[:, None], axis=1)[:, 0]
    carry0 = (qb - 1, tb - 1, tb - 1 - off_last, jnp.zeros((N,), bool),
              result.final_state, ~result.valid,
              z, z, z, z, z)
    buf0 = jnp.zeros((N, P), jnp.int32)
    _, carry, buf = jax.lax.while_loop(
        chunk_cond, chunk_body, (0, carry0, buf0))
    done = carry[5]
    packed = buf[:, 0::2] | (buf[:, 1::2] << 16)
    return TracebackResult(
        pairs=packed,
        n_pairs=carry[10],
        n_match=carry[6],
        n_mismatch=carry[7],
        n_ins=carry[8],
        n_del=carry[9],
        overflow=~done,
    )
