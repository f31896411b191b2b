// Guided banded affine DP for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (kernels/banded_cuda.py builds and registers it).
//
// Forward pass of kernels/banded.py::banded_align for the flat-cost and
// the QV-steered modes (the homopolymer-insertion band stays on XLA).
// Inputs, outputs and the traceback cell-word layout are those of
// banded_align, so banded_traceback consumes the result unchanged, and
// every value is bit-identical: costs are integer-valued f32 below 2^24,
// so sums and compares are exact in any order (built with -fmad=false
// all the same, so every f32 operation rounds like XLA's).
//
// Design (one warp per alignment, the row loop inside the kernel):
//   * lane l holds band cells 4l..4l+3 of the M/I/D carries and of the
//     packed M-run counter word in registers, for the whole alignment;
//   * a row's slope s in {0, 1, 2} (the band-offset contract of
//     map_read._band_offsets) turns the diagonal/vertical predecessor
//     fetch into three warp shuffles per array plus in-thread moves;
//   * the in-row deletion recurrence is the closed-form exclusive
//     prefix-min of banded.py: an in-thread scan plus 5 shuffle steps;
//   * per-row data (offset<<3 | read base, QV words) is loaded 32 rows at
//     a time, one row per lane, and broadcast by shuffle; the target
//     slice a 32-row chunk can touch is staged in shared memory;
//   * each lane stores its 4 cell words as one 16-byte store: a row is
//     512 contiguous bytes per warp.  Rows outside [qa, qb) are zero.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBand = 128;            // band width w_b (4 cells per lane)
constexpr int kChunk = 32;            // rows staged per chunk (one per lane)
constexpr int kTgtWords = 68;         // staged target bytes / 4: a chunk
                                      // spans <= 2*31 + 128 window bases
constexpr int kCostLen = 29;          // 5x5 matrix + ins/del open/extend
constexpr float kInf = 1e30f;         // banded.py INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStM = 0, kStI = 1, kStD = 2;
constexpr int kRunCap = 63;

// e[0] = x[-1] of the band (previous lane's last cell), e[1..4] = this
// lane's cells, e[5], e[6] = the next lane's first two cells; cells past
// either band edge read `fill`.
template <typename T>
__device__ __forceinline__ void extend(const T (&x)[4], T fill, int lane,
                                       T (&e)[7]) {
  const T up = __shfl_up_sync(kFull, x[3], 1);
  const T d0 = __shfl_down_sync(kFull, x[0], 1);
  const T d1 = __shfl_down_sync(kFull, x[1], 1);
  e[0] = lane == 0 ? fill : up;
  e[1] = x[0];
  e[2] = x[1];
  e[3] = x[2];
  e[4] = x[3];
  e[5] = lane == 31 ? fill : d0;
  e[6] = lane == 31 ? fill : d1;
}

// out[k] = e[k + off]; off is warp-uniform, so the switch never diverges.
template <typename T>
__device__ __forceinline__ void take4(const T (&e)[7], int off,
                                      T (&out)[4]) {
  switch (off) {
    case 0: out[0] = e[0]; out[1] = e[1]; out[2] = e[2]; out[3] = e[3]; break;
    case 1: out[0] = e[1]; out[1] = e[2]; out[2] = e[3]; out[3] = e[4]; break;
    case 2: out[0] = e[2]; out[1] = e[3]; out[2] = e[4]; out[3] = e[5]; break;
    default: out[0] = e[3]; out[1] = e[4]; out[2] = e[5]; out[3] = e[6]; break;
  }
}

// out[k] = x[k - 1] across the band (cell w reads cell w-1), INF at w = 0.
__device__ __forceinline__ void prev4(const float (&x)[4], int lane,
                                      float (&out)[4]) {
  const float up = __shfl_up_sync(kFull, x[3], 1);
  out[0] = lane == 0 ? kInf : up;
  out[1] = x[0];
  out[2] = x[1];
  out[3] = x[2];
}

// Exclusive scan over the warp's lanes (identity at lane 0).
__device__ __forceinline__ float warp_excl_min(float v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = fminf(v, t);
  }
  const float ex = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? kInf : ex;
}

__device__ __forceinline__ float warp_excl_sum(float v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = v + t;
  }
  const float ex = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? 0.f : ex;
}

// In-band inclusive prefix sum of x (cells 0..127 in lane order).
__device__ __forceinline__ void band_cumsum(const float (&x)[4], int lane,
                                            float (&out)[4]) {
  out[0] = x[0];
  out[1] = out[0] + x[1];
  out[2] = out[1] + x[2];
  out[3] = out[2] + x[3];
  const float ex = warp_excl_sum(out[3], lane);
  for (int k = 0; k < 4; ++k) out[k] = ex + out[k];
}

template <bool kQv>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const int32_t* __restrict__ rows,
                 const int8_t* __restrict__ windows,
                 const int32_t* __restrict__ spans,
                 const float* __restrict__ costs,
                 const int32_t* __restrict__ qv1,
                 const int32_t* __restrict__ qv2,
                 int n, int len, int wlen,
                 float* __restrict__ score_out,
                 int32_t* __restrict__ cells_out,
                 int32_t* __restrict__ state_out,
                 int32_t* __restrict__ ok_out) {
  __shared__ float s_cost[32];
  __shared__ uint32_t s_tgt[kWarpsPerBlock][kTgtWords];
  if (threadIdx.x < kCostLen) s_cost[threadIdx.x] = costs[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;  // whole warps leave together

  const float ins_open = s_cost[25], ins_ext = s_cost[26];
  const float del_open = s_cost[27], del_ext = s_cost[28];
  const int qa = spans[4 * i], qb = spans[4 * i + 1];
  const int ta = spans[4 * i + 2], tb = spans[4 * i + 3];
  const int r_lo = min(max(qa, 0), len);
  const int r_hi = max(min(qb, len), r_lo);

  int4* out = reinterpret_cast<int4*>(cells_out) +
              static_cast<size_t>(i) * len * (kBand / 4) + lane;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int r = 0; r < r_lo; ++r) out[static_cast<size_t>(r) * 32] = zero;
  for (int r = r_hi; r < len; ++r) out[static_cast<size_t>(r) * 32] = zero;

  const int8_t* win = windows + static_cast<size_t>(i) * wlen;
  uint8_t* tgt_bytes = reinterpret_cast<uint8_t*>(s_tgt[warp]);
  float wf[4];
  float pM[4], pI[4], pD[4];
  int pC[4];  // M-run counters: rexit | mrun<<2 | meq<<8 | ssum<<14
  for (int k = 0; k < 4; ++k) {
    wf[k] = static_cast<float>(4 * lane + k);
    pM[k] = pI[k] = pD[k] = kInf;
    pC[k] = 0;
  }
  int o_prev = 0;
  float fin_score = kInf;
  int fin_state = kStM, fin_ok = 0;

  for (int r0 = r_lo; r0 < r_hi; r0 += kChunk) {
    const int rr = r0 + lane;
    const bool row_in = rr < r_hi;
    const size_t row_at = static_cast<size_t>(i) * len + rr;
    const int row_w = row_in ? rows[row_at] : 0;
    int q1w = 0, q2w = 0;
    if (kQv && row_in) {
      q1w = qv1[row_at];
      q2w = qv2[row_at];
    }
    const int oc = __shfl_sync(kFull, row_w, 0) >> 3;
    __syncwarp();  // the previous chunk is done reading the target slice
    for (int j = lane; j < 4 * kTgtWords; j += 32) {
      const int t = oc + j;
      tgt_bytes[j] = t < wlen ? static_cast<uint8_t>(win[t]) : 4;
    }
    __syncwarp();

    const int nrow = min(kChunk, r_hi - r0);
    for (int j = 0; j < nrow; ++j) {
      const int r = r0 + j;
      const int rw = __shfl_sync(kFull, row_w, j);
      const int o = rw >> 3;
      const int rb = rw & 7;
      const bool first = r == qa;
      const int s = first ? 0 : o - o_prev;
      o_prev = o;
      const int t0 = o + 4 * lane;  // absolute window column of cell 0

      const int rel = o - oc;
      const uint32_t* tw = s_tgt[warp] + (rel >> 2) + lane;
      const uint32_t t4 = __funnelshift_r(tw[0], tw[1], 8 * (rel & 3));
      int tg[4];
      for (int k = 0; k < 4; ++k) tg[k] = (t4 >> (8 * k)) & 0xff;

      float insq = 0.f, delq = 0.f, subq = 0.f, dpri = 0.f, spri = 0.f;
      int dtag = 0, stag = 0;
      float cd[4] = {0.f, 0.f, 0.f, 0.f}, S[4] = {0.f, 0.f, 0.f, 0.f};
      if (kQv) {
        const int a = __shfl_sync(kFull, q1w, j);
        const int b = __shfl_sync(kFull, q2w, j);
        insq = static_cast<float>(a & 255);
        delq = static_cast<float>((a >> 8) & 255);
        subq = static_cast<float>((a >> 16) & 255);
        dtag = (a >> 24) & 7;
        stag = (a >> 27) & 7;
        dpri = static_cast<float>(b & 255);
        spri = static_cast<float>((b >> 8) & 255);
        // per-cell deletion cost (IDS Deletion) and its in-band prefix sum
        for (int k = 0; k < 4; ++k) cd[k] = tg[k] == dtag ? delq : dpri;
        band_cumsum(cd, lane, S);
      }

      // predecessor row: the virtual boundary row qa-1 at the first row
      float cM[4], cI[4], cD[4];
      if (first) {
        if (kQv) {
          // leading-deletion profile: row qa's deletion costs summed from
          // ta, including window columns [ta, o) left of the band
          float z[4], zs[4];
          for (int k = 0; k < 4; ++k) z[k] = t0 + k >= ta ? cd[k] : 0.f;
          band_cumsum(z, lane, zs);
          float pre = 0.f;
          for (int t = ta + lane; t < o; t += 32)
            pre = pre + (win[t] == dtag ? delq : dpri);
          for (int d = 16; d > 0; d >>= 1)
            pre = pre + __shfl_xor_sync(kFull, pre, d);
          for (int k = 0; k < 4; ++k)
            cD[k] = t0 + k >= ta ? pre + zs[k] : kInf;
        } else {
          for (int k = 0; k < 4; ++k)
            cD[k] = t0 + k >= ta
                        ? del_open + del_ext * static_cast<float>(t0 + k - ta)
                        : kInf;
        }
        for (int k = 0; k < 4; ++k) {
          cM[k] = t0 + k == ta - 1 ? 0.f : kInf;
          cI[k] = kInf;
        }
      } else {
        for (int k = 0; k < 4; ++k) {
          cM[k] = pM[k];
          cI[k] = pI[k];
          cD[k] = pD[k];
        }
      }

      // diagonal predecessor = prev[w + s - 1], vertical = prev[w + s]
      float eM[7], eI[7], eD[7];
      int eC[7];
      extend(cM, kInf, lane, eM);
      extend(cI, kInf, lane, eI);
      extend(cD, kInf, lane, eD);
      extend(pC, 0, lane, eC);
      float dM[4], vM[4], dI[4], vI[4], dD[4];
      int dC[4];
      take4(eM, s, dM);
      take4(eM, s + 1, vM);
      take4(eI, s, dI);
      take4(eI, s + 1, vI);
      take4(eD, s, dD);
      take4(eC, s, dC);

      const float* sub_row = s_cost + 5 * rb;
      float M[4], I[4], base[4];
      int msrc[4], iopen[4], eq[4];
      bool in_t[4];
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + k;
        in_t[k] = t >= ta && t < tb;
        // I consumes no target base: also valid at column ta-1
        const bool in_ti = t >= ta - 1 && t < tb;
        float sub = sub_row[tg[k]];
        eq[k] = rb == tg[k] && rb < 4;
        if (kQv && !eq[k]) sub = tg[k] == stag ? subq : spri;
        const float db = fminf(dM[k], fminf(dI[k], dD[k]));
        msrc[k] = dM[k] <= db ? kStM : (dI[k] <= db ? kStI : kStD);
        M[k] = in_t[k] ? sub + db : kInf;
        const float im = vM[k] + (kQv ? insq : ins_open);
        const float ii = vI[k] + (kQv ? insq : ins_ext);
        I[k] = in_ti ? fminf(im, ii) : kInf;
        iopen[k] = im <= ii;
        base[k] = fminf(M[k], I[k]);
      }

      // D[w] = min over w' < w of base[w'] + cost(w'+1..w): exclusive
      // prefix-min of base minus the running deletion cost
      float g[4];
      for (int k = 0; k < 4; ++k)
        g[k] = base[k] < kInf * 0.5f
                   ? (kQv ? base[k] - S[k] : base[k] - del_ext * wf[k])
                   : kInf;
      float l[4];
      l[0] = g[0];
      l[1] = fminf(l[0], g[1]);
      l[2] = fminf(l[1], g[2]);
      const float ex = warp_excl_min(fminf(l[2], g[3]), lane);
      const float run_prev[4] = {ex, fminf(ex, l[0]), fminf(ex, l[1]),
                                 fminf(ex, l[2])};
      float D[4];
      for (int k = 0; k < 4; ++k) {
        const float dv =
            kQv ? S[k] + run_prev[k]
                : del_ext * wf[k] + run_prev[k] + (del_open - del_ext);
        D[k] = fminf(in_t[k] ? dv : kInf, kInf);
      }

      float base_prev[4], M_prev[4], I_prev[4];
      prev4(base, lane, base_prev);
      prev4(M, lane, M_prev);
      prev4(I, lane, I_prev);

      int bits[4];
      const int s_clip = min(s, 3);
      for (int k = 0; k < 4; ++k) {
        const int dopen = D[k] >= base_prev[k] + (kQv ? cd[k] : del_open);
        const int dfromm = M_prev[k] <= I_prev[k];
        const int dc = dC[k];
        const int dX = dc & 3, dR = (dc >> 2) & 63;
        const int dE = (dc >> 8) & 63, dS = (dc >> 14) & 127;
        const bool fresh = msrc[k] != kStM || first || dR >= kRunCap;
        const int mrun = fresh ? 1 : dR + 1;
        const int meq = (fresh ? 0 : dE) + eq[k];
        const int rexit = fresh ? msrc[k] : dX;
        const int ssum = s > 2 ? 127 : min(fresh ? s : dS + s, 127);
        pC[k] = rexit | (mrun << 2) | (meq << 8) | (ssum << 14);
        bits[k] = msrc[k] | (iopen[k] << 2) | (dopen << 3) | (dfromm << 4) |
                  (eq[k] << 5) | (rexit << 7) | (mrun << 9) | (meq << 15) |
                  (s_clip << 21) | (ssum << 23);
        pM[k] = M[k];
        pI[k] = I[k];
        pD[k] = D[k];
      }
      out[static_cast<size_t>(r) * 32] =
          make_int4(bits[0], bits[1], bits[2], bits[3]);

      // final score/state at (row qb-1, column tb-1)
      if (r == qb - 1) {
        const int wcol = tb - 1 - o;
        if (wcol >= 0 && wcol < kBand) {
          const int kk = wcol & 3;
          float fm = M[0], fi = I[0], fd = D[0];
          for (int k = 1; k < 4; ++k) {
            if (kk == k) {
              fm = M[k];
              fi = I[k];
              fd = D[k];
            }
          }
          const float cb = fminf(fm, fminf(fi, fd));
          const int cs = fm <= cb ? kStM : (fi <= cb ? kStI : kStD);
          const float best = __shfl_sync(kFull, cb, wcol >> 2);
          const int bstate = __shfl_sync(kFull, cs, wcol >> 2);
          if (best < kInf * 0.5f) {
            fin_score = best;
            fin_state = bstate;
            fin_ok = 1;
          }
        }
      }
    }
  }

  if (lane == 0) {
    score_out[i] = fin_score;
    state_out[i] = fin_state;
    ok_out[i] = fin_ok;
  }
}

template <bool kQv>
ffi::Error Launch(cudaStream_t stream, ffi::Buffer<ffi::S32> rows,
                  ffi::Buffer<ffi::S8> windows, ffi::Buffer<ffi::S32> spans,
                  ffi::Buffer<ffi::F32> costs, const int32_t* qv1,
                  const int32_t* qv2, ffi::ResultBuffer<ffi::F32> score,
                  ffi::ResultBuffer<ffi::S32> cells,
                  ffi::ResultBuffer<ffi::S32> state,
                  ffi::ResultBuffer<ffi::S32> ok) {
  const auto rd = rows.dimensions();
  const auto wd = windows.dimensions();
  const auto cdims = cells->dimensions();
  if (rd.size() != 2 || wd.size() != 2 || wd[0] != rd[0] ||
      spans.element_count() != 4 * static_cast<size_t>(rd[0]) ||
      costs.element_count() < kCostLen || cdims.size() != 3 ||
      cdims[0] != rd[0] || cdims[1] != rd[1] || cdims[2] != kBand) {
    return ffi::Error::InvalidArgument(
        "banded_dp: expected rows [N, L], windows [N, W], spans [N, 4], "
        "costs [>=29], cells [N, L, 128]");
  }
  const int n = static_cast<int>(rd[0]);
  if (n == 0) return ffi::Error::Success();
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  banded_dp_kernel<kQv><<<grid, block, 0, stream>>>(
      rows.typed_data(), windows.typed_data(), spans.typed_data(),
      costs.typed_data(), qv1, qv2, n, static_cast<int>(rd[1]),
      static_cast<int>(wd[1]), score->typed_data(), cells->typed_data(),
      state->typed_data(), ok->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("banded_dp launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error BandedDp(cudaStream_t stream, ffi::Buffer<ffi::S32> rows,
                    ffi::Buffer<ffi::S8> windows, ffi::Buffer<ffi::S32> spans,
                    ffi::Buffer<ffi::F32> costs,
                    ffi::ResultBuffer<ffi::F32> score,
                    ffi::ResultBuffer<ffi::S32> cells,
                    ffi::ResultBuffer<ffi::S32> state,
                    ffi::ResultBuffer<ffi::S32> ok) {
  return Launch<false>(stream, rows, windows, spans, costs, nullptr, nullptr,
                       score, cells, state, ok);
}

ffi::Error BandedDpQv(cudaStream_t stream, ffi::Buffer<ffi::S32> rows,
                      ffi::Buffer<ffi::S8> windows,
                      ffi::Buffer<ffi::S32> spans, ffi::Buffer<ffi::F32> costs,
                      ffi::Buffer<ffi::S32> qv1, ffi::Buffer<ffi::S32> qv2,
                      ffi::ResultBuffer<ffi::F32> score,
                      ffi::ResultBuffer<ffi::S32> cells,
                      ffi::ResultBuffer<ffi::S32> state,
                      ffi::ResultBuffer<ffi::S32> ok) {
  if (qv1.element_count() != rows.element_count() ||
      qv2.element_count() != rows.element_count())
    return ffi::Error::InvalidArgument("banded_dp_qv: qv1/qv2 must be [N, L]");
  return Launch<true>(stream, rows, windows, spans, costs, qv1.typed_data(),
                      qv2.typed_data(), score, cells, state, ok);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BlasrBandedDp, BandedDp,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // rows: offset << 3 | read base
        .Arg<ffi::Buffer<ffi::S8>>()    // windows
        .Arg<ffi::Buffer<ffi::S32>>()   // spans: qa, qb, ta, tb
        .Arg<ffi::Buffer<ffi::F32>>()   // costs: submat[25], gaps[4]
        .Ret<ffi::Buffer<ffi::F32>>()   // score
        .Ret<ffi::Buffer<ffi::S32>>()   // traceback cell words
        .Ret<ffi::Buffer<ffi::S32>>()   // final state
        .Ret<ffi::Buffer<ffi::S32>>()); // reached the end cell

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BlasrBandedDpQv, BandedDpQv,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // qv1 packed per-row QV costs
        .Arg<ffi::Buffer<ffi::S32>>()   // qv2 packed per-row priors
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());
