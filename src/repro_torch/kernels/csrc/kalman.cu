// kalman_scan: the scalar Kalman filter of the riot `kalman` operator,
// rows in sequence, bitwise the plain version.
//
// A helper of the stream path, not a port of a TPU kernel: the reference
// runs this recurrence as a row-sequential lax.scan (repro/ops/riot.py,
// `kalman`). Per row and channel:
//   p- = p + q;  k = p- / (p- + r);  xe <- xe + k (z - xe);  p <- (1 - k) p-
// Every operation is a _rn intrinsic in this order, so the result is
// bitwise the plain version's (kernels/ref.py:kalman_scan_ref).
//
// What bounds it: the xe recurrence is sequential and may not be
// reassociated (bitwise), so its floor is rows x the latency of one
// dependent fsub, fmul and fadd (12 cycles: 99 us for 16384 rows at 1.98
// GHz), not memory (16384 x 5 floats in and out, 0.2 us). So nothing but
// that chain may sit on its critical path: not the loads of z, not the
// stores of y, not the gain's IEEE divide. A block of four warps serves
// up to kChannels channels, one lane per channel in each role, over tiles
// of kTile rows with one barrier per tile:
//   * warp 0, the xe chain: xe + k (z - xe) for tile t, z and k read from
//     shared memory, y written to shared memory;
//   * warp 1, the gain chain: k for tile t + 1. The chain p -> (p-, k, p)
//     never reads the data: it is a fixed map of the f32 value p. So once
//     p repeats bit for bit (p_m == p_{m-d}, d <= kMaxPeriod, compared by
//     their bits so that -0 and +0 differ; NaN never matches), every later
//     k and p repeats with period d, and the lane stops dividing. From
//     (q, r) = (0.1, 1.0) and p = 1 that happens after 27 rows; from the
//     fixed point (the stream's second step on), after one. The rest of
//     each tile's k is filled from the d values kept, by the whole warp;
//   * warps 2-3: cp.async copies of z for tile t + 2 into shared memory
//     (three buffers, so a copy has two tiles of the chain to land), and y
//     of tile t - 1 out to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 16;   // channels per block (lanes of each role)
constexpr int kTile = 256;      // rows per tile
constexpr int kBatch = 8;       // rows of z and k the chain reads ahead
constexpr int kThreads = 128;   // chain warp, gain warp, two copy warps
constexpr int kCopyThreads = kThreads - 64;
constexpr int kMaxPeriod = 8;   // cycles of p up to this length are detected

constexpr int kZStages = 3;     // z tiles in flight: copied two tiles ahead of the chain

struct KalmanSmem {
  float z[kZStages][kTile + kBatch][kChannels];  // + kBatch: the chain's read-ahead past a tile
  float k[2][kTile + kBatch][kChannels];
  float y[2][kTile][kChannels];
  float kper[kChannels][kMaxPeriod];  // k over one period, from the row conv - d on
  float pper[kChannels][kMaxPeriod];  // p likewise
  int64_t conv[kChannels];            // first row taken from the period (-1: none yet)
  int64_t filled[kChannels];          // rows whose k the gain lane computed itself
  int period[kChannels];
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The gain lane of one channel: computes k row by row until p repeats.
struct Gain {
  // m below is the next row whose k is computed
  float p;                  // p before row m
  float ph[kMaxPeriod];     // ph[i] = p before row m - i
  float kh[kMaxPeriod - 1]; // kh[i] = k of row m - 1 - i
  int64_t conv;             // first row taken from the period (-1: none yet)
  int period;

  // k of rows [r0, r1) into dst[m - r0][c] until p repeats; returns the
  // first row not filled
  __device__ int64_t run(float (*dst)[kChannels], int64_t r0, int64_t r1, float q, float r_,
                         KalmanSmem& sm, int c) {
    int64_t m = r0;
    for (; m < r1 && conv < 0; ++m) {
      const float p_pred = __fadd_rn(p, q);
      const float k = __fdiv_rn(p_pred, __fadd_rn(p_pred, r_));
      const float p_new = __fmul_rn(__fsub_rn(1.0f, k), p_pred);
      dst[m - r0][c] = k;
      // p after row m is p_{m+1}; ph[d-1] = p_{m+1-d}
      int d = 0;
#pragma unroll
      for (int i = kMaxPeriod; i >= 1; --i)
        if (i <= m + 1 && p_new == p_new && __float_as_uint(p_new) == __float_as_uint(ph[i - 1]))
          d = i;  // the smallest period wins
      if (d > 0) {
        // rows from m + 1 on repeat rows m + 1 - d ... m
        conv = m + 1;
        period = d;
        sm.conv[c] = conv;
        sm.period[c] = d;
        sm.kper[c][d - 1] = k;
#pragma unroll
        for (int i = 0; i < kMaxPeriod - 1; ++i)
          if (i <= d - 2) sm.kper[c][d - 2 - i] = kh[i];
#pragma unroll
        for (int i = 0; i < kMaxPeriod; ++i)
          if (i <= d - 1) sm.pper[c][d - 1 - i] = ph[i];
      }
#pragma unroll
      for (int i = kMaxPeriod - 1; i > 0; --i) ph[i] = ph[i - 1];
      ph[0] = p_new;
#pragma unroll
      for (int i = kMaxPeriod - 2; i > 0; --i) kh[i] = kh[i - 1];
      kh[0] = k;
      p = p_new;
    }
    return m;
  }

  // p after all `rows` rows
  __device__ float final_p(int64_t rows, const KalmanSmem& sm, int c) const {
    if (conv < 0 || rows < conv) return p;
    return sm.pper[c][(rows - conv) % period];
  }
};

// The gain warp's work for rows [r0, r1): each lane computes its channel's
// gains until they repeat, then the warp fills the rest of the tile from
// the periods. Rows whose index is one residue mod d share one k, so lane l
// takes channel l % 16 and every other residue (from l / 16): a store and
// an add per row, no dependent chain.
__device__ __forceinline__ void gain_tile(Gain& g, KalmanSmem& sm, float (*dst)[kChannels],
                                          int64_t r0, int64_t r1, float q, float r, int nch,
                                          int lane) {
  static_assert(kChannels == 16, "two lanes of the gain warp per channel");
  if (lane < nch) sm.filled[lane] = g.run(dst, r0, r1, q, r, sm, lane);
  __syncwarp();
  const int c = lane & 15;
  if (c >= nch || sm.filled[c] >= r1) return;
  const int d = sm.period[c];
  const int n = static_cast<int>(r1 - r0);
  const int start = static_cast<int>(sm.filled[c] - r0);  // first row from the period
  const int base = static_cast<int>((sm.filled[c] - sm.conv[c]) % d);  // its index in kper
  for (int s = lane >> 4; s < d; s += 2) {
    const float v = sm.kper[c][(base + s) % d];
#pragma unroll 4
    for (int i = start + s; i < n; i += d) dst[i][c] = v;
  }
}

__global__ void __launch_bounds__(kThreads) kalman_scan_kernel(
    const float* __restrict__ z, int64_t stride, const float* __restrict__ xe0,
    const float* __restrict__ p0, float* __restrict__ y, float* __restrict__ xe1,
    float* __restrict__ p1, int64_t rows, int channels, float q, float r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KalmanSmem& sm = *reinterpret_cast<KalmanSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch0 = blockIdx.x * kChannels;
  const int nch = min(kChannels, channels - ch0);
  const int64_t tiles = (rows + kTile - 1) / kTile;

  // copy warps: z rows of tile t into sm.z[t % kZStages] (one commit group
  // per tile, empty past the last); y of tile t out of sm.y[t & 1]
  auto stage_z = [&](int64_t t) {
    const int64_t r0 = t * kTile;
    const int n = t < tiles ? static_cast<int>(lmin(kTile, rows - r0)) * nch : 0;
    float(*dst)[kChannels] = sm.z[t % kZStages];
    for (int e = tid - 64; e < n; e += kCopyThreads) {
      const int i = e / nch, c = e % nch;
      cp_async4(&dst[i][c], z + (r0 + i) * stride + ch0 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto write_y = [&](int64_t t) {
    const int64_t r0 = t * kTile;
    const int n = static_cast<int>(lmin(kTile, rows - r0)) * nch;
    for (int e = tid - 64; e < n; e += kCopyThreads) {
      const int i = e / nch, c = e % nch;
      y[(r0 + i) * channels + ch0 + c] = sm.y[t & 1][i][c];
    }
  };

  Gain g;
  if (warp == 1) {
    if (lane < nch) {
      g.p = p0[ch0 + lane];
      g.ph[0] = g.p;
#pragma unroll
      for (int i = 1; i < kMaxPeriod; ++i) g.ph[i] = 0.0f;  // not compared before they are set
#pragma unroll
      for (int i = 0; i < kMaxPeriod - 1; ++i) g.kh[i] = 0.0f;
      g.conv = -1;
      g.period = 1;
    }
    if (tiles > 0) gain_tile(g, sm, sm.k[0], 0, lmin(kTile, rows), q, r, nch, lane);
  }
  if (warp >= 2 && tiles > 0) {
    stage_z(0);
    stage_z(1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile 0 has landed
  }
  float xe = (warp == 0 && lane < nch) ? xe0[ch0 + lane] : 0.0f;
  __syncthreads();

  for (int64_t t = 0; t < tiles; ++t) {
    const int b = static_cast<int>(t & 1);
    const int64_t r0 = t * kTile;
    const int n = static_cast<int>(lmin(kTile, rows - r0));
    if (warp == 0) {
      if (lane < nch) {
        // the dependent chain: fsub, fmul, fadd per row. z and k of the next
        // kBatch rows are read while this batch runs, so no shared-memory
        // load sits in the chain (the buffers hold kBatch rows of slack for
        // the read past the tile's last row)
        const float* zb = &sm.z[t % kZStages][0][lane];
        const float* kb = &sm.k[b][0][lane];
        float* yb = &sm.y[b][0][lane];
        float za[kBatch], ka[kBatch], zn[kBatch], kn[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          za[u] = zb[u * kChannels];
          ka[u] = kb[u * kChannels];
        }
        int i = 0;
        // two batches a turn, each read while the other runs
        for (; i + 2 * kBatch <= n; i += 2 * kBatch) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            zn[u] = zb[(i + kBatch + u) * kChannels];
            kn[u] = kb[(i + kBatch + u) * kChannels];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            xe = __fadd_rn(xe, __fmul_rn(ka[u], __fsub_rn(za[u], xe)));
            yb[(i + u) * kChannels] = xe;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            za[u] = zb[(i + 2 * kBatch + u) * kChannels];
            ka[u] = kb[(i + 2 * kBatch + u) * kChannels];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            xe = __fadd_rn(xe, __fmul_rn(kn[u], __fsub_rn(zn[u], xe)));
            yb[(i + kBatch + u) * kChannels] = xe;
          }
        }
        for (; i < n; ++i) {
          xe = __fadd_rn(xe, __fmul_rn(kb[i * kChannels], __fsub_rn(zb[i * kChannels], xe)));
          yb[i * kChannels] = xe;
        }
      }
    } else if (warp == 1) {
      if (t + 1 < tiles) {
        const int64_t n1 = r0 + kTile;
        gain_tile(g, sm, sm.k[b ^ 1], n1, lmin(n1 + kTile, rows), q, r, nch, lane);
      }
    } else {
      stage_z(t + 2);
      if (t > 0) write_y(t - 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t + 1 has landed
    }
    __syncthreads();
  }
  if (warp >= 2 && tiles > 0) write_y(tiles - 1);
  if (warp == 0 && lane < nch) xe1[ch0 + lane] = xe;
  if (warp == 1 && lane < nch) p1[ch0 + lane] = g.final_p(rows, sm, lane);
}

}  // namespace

extern "C" int rt_kalman_scan(const float* z, int64_t stride, const float* xe0, const float* p0,
                              float* y, float* xe1, float* p1, int64_t rows, int channels,
                              float q, float r, void* stream) {
  if (channels <= 0) return cudaSuccess;
  const int smem = static_cast<int>(sizeof(KalmanSmem));
  // above 48 KB only after opting in; the attribute belongs to the current
  // device, so it is set on every launch
  const cudaError_t e =
      cudaFuncSetAttribute(kalman_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kalman_scan_kernel<<<(channels + kChannels - 1) / kChannels, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      z, stride, xe0, p0, y, xe1, p1, rows, channels, q, r);
  return cudaGetLastError();
}
