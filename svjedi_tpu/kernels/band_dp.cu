// Banded affine-gap local alignment on Hopper: one warp per DP problem.
//
// Same contract as align/extend.py band_dp_batch applied to the windows
// that align/device.py window_score fetches: per problem (score, qs, ts,
// qe, te), bit-identical, ties included. The kernel reads its windows
// straight from the uploaded read and panel buffers by the (5, P) metadata
// (q_start, m, t_start, t_lo, t_hi), so no window matrix is ever written to
// device memory.
//
// Layout: the band of B = 32 * CPL cells lives in registers, lane l holding
// the CPL contiguous offsets k = l*CPL .. l*CPL+CPL-1. Per read row:
//   - vertical-gap parents (offset k+1) and the target shift come from one
//     __shfl_down_sync per carried array;
//   - horizontal gap runs are an exclusive prefix max over the band of
//     key(j) = ((H[j] - ext*j) << 8 | j) << 32 | start(j): in-lane over the
//     CPL cells, then a 5-step __shfl_up_sync scan across lanes. The j bits
//     make the largest j win ties, which is the doubling scan's rule in
//     band_dp_batch; start(j) rides along in the low word;
//   - the row maximum with the lowest offset on ties is one
//     __reduce_max_sync of (H << 8 | 255 - k).
// Start coordinates are packed as (row << 16 | target), so bucket + band
// must stay below 65536 (checked by the Python wrapper).
//
// Rows at or past a problem's window length m hold only sentinel read
// bases: every move from them lowers a score, so they can never improve the
// best cell and each warp stops at row min(m, bucket).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

struct Scores {
  int match;
  int mismatch;
  int open_extend;
  int extend;
};

__device__ __forceinline__ int64_t clip_index(int64_t idx, int64_t n) {
  return idx < 0 ? 0 : (idx >= n ? n - 1 : idx);
}

// Read base of window row i (sentinel 4 past the window length).
__device__ __forceinline__ int read_code(const int8_t* __restrict__ reads2,
                                         int64_t n, int64_t q_start, int i,
                                         int m) {
  if (i >= m) return 4;
  return reads2[clip_index(q_start + i, n)];
}

// Target base at window column j (sentinel 4 outside the path's bounds).
__device__ __forceinline__ int target_code(const int8_t* __restrict__ panel,
                                           int64_t n, int64_t t_start,
                                           int64_t t_lo, int64_t t_hi, int j) {
  const int64_t idx = t_start + j;
  if (idx < t_lo || idx >= t_hi) return 4;
  return panel[clip_index(idx, n)];
}

template <int CPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    band_dp_kernel(const int8_t* __restrict__ reads2, int64_t n_reads2,
                   const int8_t* __restrict__ panel, int64_t n_panel,
                   const int32_t* __restrict__ meta, int64_t n_problems,
                   int bucket, Scores sc, int32_t* __restrict__ out) {
  constexpr int B = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_problems) return;  // warp-uniform

  const int64_t q_start = meta[p];
  const int m = meta[n_problems + p];
  const int64_t t_start = meta[2 * n_problems + p];
  const int64_t t_lo = meta[3 * n_problems + p];
  const int64_t t_hi = meta[4 * n_problems + p];
  const int rows = min(max(m, 0), bucket);
  const int k0 = lane * CPL;

  int H[CPL], V[CPL], T[CPL];
  unsigned SH[CPL], SV[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    H[c] = 0;
    V[c] = kNeg;
    SH[c] = static_cast<unsigned>(k0 + c);
    SV[c] = static_cast<unsigned>(k0 + c);
    T[c] = target_code(panel, n_panel, t_start, t_lo, t_hi, k0 + c);
  }
  int best = 0, best_qe = -1, best_te = -1;
  unsigned best_start = 0;

  // Row inputs arrive 32 rows at a time, one row per lane: the read base
  // of row i and the target base entering the band at row i (column
  // i + B - 1), packed in one word and prefetched a block ahead.
  auto row_input = [&](int i) {
    return read_code(reads2, n_reads2, q_start, i, m) |
           (target_code(panel, n_panel, t_start, t_lo, t_hi, i + B - 1) << 8);
  };
  int next = row_input(lane);

  for (int i0 = 0; i0 < rows; i0 += 32) {
    const int cur = next;
    if (i0 + 32 < rows) next = row_input(i0 + 32 + lane);
    const int n_rows = min(32, rows - i0);
    for (int r = 0; r < n_rows; ++r) {
      const int i = i0 + r;
      const int packed = __shfl_sync(kFull, cur, r);
      const int qi = packed & 0xff;
      if (i > 0) {
        const int t_in = __shfl_down_sync(kFull, T[0], 1);
#pragma unroll
        for (int c = 0; c + 1 < CPL; ++c) T[c] = T[c + 1];
        T[CPL - 1] = lane == 31 ? (packed >> 8) : t_in;
      }

      // Vertical gap: parent at offset k+1 (previous row).
      int h_dn = __shfl_down_sync(kFull, H[0], 1);
      int v_dn = __shfl_down_sync(kFull, V[0], 1);
      unsigned sh_dn = __shfl_down_sync(kFull, SH[0], 1);
      unsigned sv_dn = __shfl_down_sync(kFull, SV[0], 1);
      if (lane == 31) {
        h_dn = kNeg;
        v_dn = kNeg;
        sh_dn = 0;
        sv_dn = 0;
      }

      int ht[CPL];
      unsigned st[CPL];
      long long key[CPL];
      long long run = -1;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int k = k0 + c;
        const int h_up = c + 1 < CPL ? H[c + 1] : h_dn;
        const int v_up = c + 1 < CPL ? V[c + 1] : v_dn;
        const unsigned sh_up = c + 1 < CPL ? SH[c + 1] : sh_dn;
        const unsigned sv_up = c + 1 < CPL ? SV[c + 1] : sv_dn;
        const int v_open = h_up + sc.open_extend;
        const int v_ext = v_up + sc.extend;
        const int v_new = max(v_open, v_ext);
        const unsigned sv_new = v_open >= v_ext ? sh_up : sv_up;

        const int sub = (qi == T[c] && qi < 4) ? sc.match : sc.mismatch;
        const int diag = H[c] + sub;
        int h = max(diag, v_new);
        unsigned s = diag >= v_new ? SH[c] : sv_new;
        if (h <= 0) {
          // Empty cell: a new alignment starts at its diagonal successor.
          h = 0;
          s = (static_cast<unsigned>(i + 1) << 16) |
              static_cast<unsigned>(i + 1 + k);
        }
        ht[c] = h;
        st[c] = s;
        V[c] = v_new;
        SV[c] = sv_new;
        const unsigned hi = (static_cast<unsigned>(h - sc.extend * k) << 8) |
                            static_cast<unsigned>(k);
        key[c] = static_cast<long long>(
            (static_cast<unsigned long long>(hi) << 32) | s);
        run = max(run, key[c]);
      }

      // Horizontal gap: exclusive prefix max of key over offsets j < k.
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long o = __shfl_up_sync(kFull, run, d);
        if (lane >= d) run = max(run, o);
      }
      long long ex = __shfl_up_sync(kFull, run, 1);
      if (lane == 0) ex = -1;

      int row_key = -1;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int k = k0 + c;
        int h = ht[c];
        unsigned s = st[c];
        if (ex >= 0) {
          const int g = static_cast<int>(ex >> 40);
          const int f = g + sc.open_extend + sc.extend * (k - 1);
          if (f > h) {
            h = f;
            s = static_cast<unsigned>(ex & 0xffffffffll);
          }
        }
        ex = max(ex, key[c]);
        H[c] = h;
        SH[c] = s;
        row_key = max(row_key, (h << 8) | (255 - k));
      }

      // Row best: highest score, lowest offset; kept only if it strictly
      // improves on every earlier row.
      row_key = __reduce_max_sync(kFull, row_key);
      if ((row_key >> 8) > best) {
        const int k_best = 255 - (row_key & 0xff);
        const int c_best = k_best % CPL;
        unsigned mine = SH[0];
#pragma unroll
        for (int c = 1; c < CPL; ++c)
          if (c == c_best) mine = SH[c];
        best = row_key >> 8;
        best_start = __shfl_sync(kFull, mine, k_best / CPL);
        best_qe = i;
        best_te = i + k_best;
      }
    }
  }

  if (lane == 0) {
    int32_t* o = out + 5 * p;
    o[0] = best;
    o[1] = static_cast<int32_t>(best_start >> 16);
    o[2] = static_cast<int32_t>(best_start & 0xffffu);
    o[3] = best_qe;
    o[4] = best_te;
  }
}

template <int CPL>
void launch(cudaStream_t stream, const int8_t* reads2, int64_t n_reads2,
            const int8_t* panel, int64_t n_panel, const int32_t* meta,
            int64_t n_problems, int bucket, Scores sc, int32_t* out) {
  const int64_t blocks = (n_problems + kWarpsPerBlock - 1) / kWarpsPerBlock;
  band_dp_kernel<CPL><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                        0, stream>>>(reads2, n_reads2, panel, n_panel, meta,
                                     n_problems, bucket, sc, out);
}

ffi::Error BandDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> reads2,
                      ffi::Buffer<ffi::S8> panel, ffi::Buffer<ffi::S32> meta,
                      ffi::ResultBuffer<ffi::S32> out, int64_t bucket,
                      int64_t band, int64_t match, int64_t mismatch,
                      int64_t gap_open, int64_t gap_extend) {
  const auto dims = meta.dimensions();
  if (dims.size() != 2 || dims[0] != 5) {
    return ffi::Error::InvalidArgument("band_dp: meta must have shape (5, P)");
  }
  const int64_t n_problems = dims[1];
  const auto out_dims = out->dimensions();
  if (out_dims.size() != 2 || out_dims[0] != n_problems || out_dims[1] != 5) {
    return ffi::Error::InvalidArgument("band_dp: result must have shape (P, 5)");
  }
  if (n_problems == 0) return ffi::Error::Success();
  const Scores sc{static_cast<int>(match), static_cast<int>(mismatch),
                  static_cast<int>(gap_open + gap_extend),
                  static_cast<int>(gap_extend)};
  const int8_t* r = reads2.typed_data();
  const int8_t* t = panel.typed_data();
  const int64_t nr = static_cast<int64_t>(reads2.element_count());
  const int64_t nt = static_cast<int64_t>(panel.element_count());
  const int bk = static_cast<int>(bucket);
  int32_t* o = out->typed_data();
  switch (band) {
    case 32:
      launch<1>(stream, r, nr, t, nt, meta.typed_data(), n_problems, bk, sc, o);
      break;
    case 64:
      launch<2>(stream, r, nr, t, nt, meta.typed_data(), n_problems, bk, sc, o);
      break;
    case 128:
      launch<4>(stream, r, nr, t, nt, meta.typed_data(), n_problems, bk, sc, o);
      break;
    case 256:
      launch<8>(stream, r, nr, t, nt, meta.typed_data(), n_problems, bk, sc, o);
      break;
    default:
      return ffi::Error::InvalidArgument(
          "band_dp: band must be 32, 64, 128 or 256");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("band_dp launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SvtBandDp, BandDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int64_t>("bucket")
                                  .Attr<int64_t>("band")
                                  .Attr<int64_t>("match")
                                  .Attr<int64_t>("mismatch")
                                  .Attr<int64_t>("gap_open")
                                  .Attr<int64_t>("gap_extend"));
