// K7 ssd_scan: the Mamba2 chunked SSD (state-space dual) scan.
//
// Replaces the Pallas kernel repro/kernels/ssd.py:ssd_scan (pallas_call at
// :90, kernel body _ssd_kernel at :25-69). There the TPU runs the chunks as
// the innermost, sequential grid axis with the (N x P) f32 state in VMEM
// scratch. Blocks on Hopper run in no order, so here one block owns one
// (batch, head) and walks its chunks itself, the state h in shared memory
// from the first chunk to the last; it never goes to device memory between
// chunks. Per chunk of L positions (cum = inclusive cumsum of dt * a):
//   W[i][j] = exp(cum_i - cum_j) * (C_i . B_j) * dt_j   for j <= i, else 0
//   y_i     = exp(cum_i) * (C_i . h) + sum_j W[i][j] x_j
//   h      <- exp(cum_last) * h + sum_j B_j (x) (x_j * exp(cum_last - cum_j) * dt_j)
// All math in f32 with expf; x, B and C (f32 or bf16) are converted to f32
// as they are staged. Outputs: y (B, S, nh, P) f32 and the final h
// (B, nh, N, P) f32; an optional h0 seeds the state.
//
// Ragged length: S need not be a multiple of L. Positions >= S are staged
// as dt = 0 and x = B = C = 0: their decay is exp(0) = 1 and they add
// nothing to W, y or h, so the last, partial chunk gives exactly the
// result of a shorter chunk (y past S is not written). The reference's jnp
// scan instead shrinks the chunk to a divisor of S; the port never does.
//
// Bound by operations: per (head, chunk) of l positions, C.B^T and W.x
// over the causal half (the l(l+1)/2 pairs j <= i; W is zero above the
// diagonal) and the two state products C.h and B^T.x, that is
// 2 * (l(l+1)/2 * (N + P) + 2 l N P). For a 2048-token prefill at zamba2's
// 80 heads of P = 64, N = 64, L = 128 that is 5.39 GFLOP, about 80 us at
// 67 TFLOP/s f32 (the type the Pallas kernel computes in); the bytes (xh,
// dt, B, C in, y and h out, 65 MB) take 19.5 us. This first version runs
// plain f32 FMAs from shared memory on a 16 x 16 thread grid, each thread a
// register tile of up to 8 x 8 outputs, and computes the whole L x L square
// of W with the causal mask applied per element. The redesign takes up, in
// order: occupancy (one block per (batch, head) gives 80 blocks on 132 SMs
// at batch 1; a split over chunk ranges with a second pass for the state
// would fill the card), tensor cores (wgmma on C.B^T and W.x) and skipping
// the upper triangle.
//
// Shared memory (f32): x [L][P], B and C [L][N+1] (padded: a warp reads 16
// rows of B at one column), h [N][P], a row tile of W [wi][L+1], and cum,
// dt, exp(cum), the end weights [L] each. At (L, N, P) = (128, 64, 64)
// with wi = L that is 183,808 bytes (opt-in above 48 KB). Where a whole W
// would not fit, the wrapper passes a smaller row tile wi and the block
// computes W and y tile by tile: tests/test_kernels.py's (L, N, P) =
// (128, 128, 64) runs with wi = 32. L, N and P above 128 exceed the
// register tiles and are refused (the wrapper raises before the launch).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // the threads as a 16 x 16 grid (ty, tx)
constexpr int kMaxTile = 8;     // register tile per side: dimensions up to 128
constexpr int kMaxDim = kGrid * kMaxTile;

struct SsdArgs {
  const void* x;      // (B, S, nh, P)
  const float* dt;    // (B, S, nh), softplus'd
  const float* a;     // (nh,), negative
  const void* bm;     // (B, S, N)
  const void* cm;     // (B, S, N)
  const float* h0;    // (B, nh, N, P) packed, or null for a zero state
  float* y;           // (B, S, nh, P) packed
  float* h;           // (B, nh, N, P) packed
  int64_t x_sb, x_ss, x_sh;     // element strides; inner stride 1
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int s, nh, p, n, chunk;
  int wi;  // rows of W per tile
};

__host__ __device__ constexpr int ssd_smem_floats(int l, int n, int p, int wi) {
  return l * p + 2 * l * (n + 1) + n * p + wi * (l + 1) + 4 * l;
}

// TP: register-tile columns over P (P <= kGrid * TP).
template <typename T, int TP>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(SsdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, N = a.n, P = a.p;
  const int BP = N + 1, WP = L + 1;
  float* xs = smem;              // [L][P]
  float* bs = xs + L * P;        // [L][BP]
  float* cs = bs + L * BP;       // [L][BP]
  float* hs = cs + L * BP;       // [N][P]: the state
  float* ws = hs + N * P;        // [wi][WP]: a row tile of W
  float* cum = ws + a.wi * WP;   // [L]
  float* dts = cum + L;          // [L]
  float* ecum = dts + L;         // [L]: exp(cum_i)
  float* wend = ecum + L;        // [L]: exp(cum_last - cum_j) * dt_j

  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const float decay = a.a[head];
  const int64_t bh = static_cast<int64_t>(b) * a.nh + head;

  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + head * a.x_sh;
  const float* dtb = a.dt + b * a.dt_sb + head * a.dt_sh;
  const T* bb = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cb = static_cast<const T*>(a.cm) + b * a.c_sb;
  float* yb = a.y + static_cast<int64_t>(b) * a.s * a.nh * P + static_cast<int64_t>(head) * P;
  const int64_t y_ss = static_cast<int64_t>(a.nh) * P;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = a.h0 ? a.h0[bh * N * P + i] : 0.0f;

  for (int c0 = 0; c0 < a.s; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = c0 + i / P;
      xs[i] = t < a.s ? rt::load_f32(xb + t * a.x_ss + i % P) : 0.0f;
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int r = i / N, col = i % N;
      const int t = c0 + r;
      const bool in = t < a.s;
      bs[r * BP + col] = in ? rt::load_f32(bb + t * a.b_ss + col) : 0.0f;
      cs[r * BP + col] = in ? rt::load_f32(cb + t * a.c_ss + col) : 0.0f;
    }
    if (tid < 32) {
      // cum: each lane sums a run of consecutive positions, then a warp scan
      // of the runs' totals gives each run its offset.
      const int lane = tid;
      const int per = (L + 31) / 32;
      float vals[kMaxDim / 32];
      float dvals[kMaxDim / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxDim / 32; ++k) {
        const int t = lane * per + k;
        const bool in = k < per && t < L && c0 + t < a.s;
        dvals[k] = in ? dtb[(c0 + t) * a.dt_ss] : 0.0f;
        run += dvals[k] * decay;
        vals[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float off = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) off = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxDim / 32; ++k) {
        const int t = lane * per + k;
        if (k < per && t < L) {
          cum[t] = off + vals[k];
          dts[t] = dvals[k];
        }
      }
      __syncwarp();
      const float last = cum[L - 1];
      for (int t = lane; t < L; t += 32) {
        ecum[t] = expf(cum[t]);
        wend[t] = expf(last - cum[t]) * dts[t];
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += a.wi) {
      const int rows = min(a.wi, L - i0);
      // W rows [i0, i0 + rows): thread (ty, tx) owns i = i0 + ty + 16u, j = tx + 16v
      {
        float acc[kMaxTile][kMaxTile];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) acc[u][v] = 0.0f;
        for (int k = 0; k < N; ++k) {
          float cv[kMaxTile], bv[kMaxTile];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            cv[u] = r < rows ? cs[(i0 + r) * BP + k] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) {
            const int j = tx + kGrid * v;
            bv[v] = j < L ? bs[j * BP + k] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < kMaxTile; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          if (r >= rows) continue;
          const int i = i0 + r;
#pragma unroll
          for (int v = 0; v < kMaxTile; ++v) {
            const int j = tx + kGrid * v;
            if (j < L) ws[r * WP + j] = j <= i ? expf(cum[i] - cum[j]) * acc[u][v] * dts[j] : 0.0f;
          }
        }
      }
      __syncthreads();
      // y rows of the tile: thread (ty, tx) owns i = i0 + ty + 16u, p = tx + 16v
      {
        float acc[kMaxTile][TP];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = 0.0f;
        for (int k = 0; k < N; ++k) {  // C_i . h, the state before this chunk
          float cv[kMaxTile], hv[TP];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            cv[u] = r < rows ? cs[(i0 + r) * BP + k] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            hv[v] = p < P ? hs[k * P + p] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(cv[u], hv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          const float e = r < rows ? ecum[i0 + r] : 0.0f;
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] *= e;
        }
        for (int j = 0; j < i0 + rows; ++j) {  // W is zero past the tile's last row
          float wv[kMaxTile], xv[TP];
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u) {
            const int r = ty + kGrid * u;
            wv[u] = r < rows ? ws[r * WP + j] : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            xv[v] = p < P ? xs[j * P + p] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
            for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(wv[u], xv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int r = ty + kGrid * u;
          const int t = c0 + i0 + r;
          if (r >= rows || t >= a.s) continue;
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const int p = tx + kGrid * v;
            if (p < P) yb[t * y_ss + p] = acc[u][v];
          }
        }
      }
      __syncthreads();  // ws is rewritten by the next tile; hs is read until here
    }

    // h <- exp(cum_last) h + B^T (x * wend): thread (ty, tx) owns n = ty + 16u, p = tx + 16v
    {
      const float el = ecum[L - 1];
      float acc[kMaxTile][TP];
#pragma unroll
      for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
        for (int v = 0; v < TP; ++v) acc[u][v] = 0.0f;
      for (int j = 0; j < L; ++j) {
        const float w = wend[j];
        float bv[kMaxTile], xv[TP];
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u) {
          const int n = ty + kGrid * u;
          bv[u] = n < N ? bs[j * BP + n] : 0.0f;
        }
#pragma unroll
        for (int v = 0; v < TP; ++v) {
          const int p = tx + kGrid * v;
          xv[v] = p < P ? xs[j * P + p] * w : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kMaxTile; ++u)
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = fmaf(bv[u], xv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < kMaxTile; ++u) {
        const int n = ty + kGrid * u;
        if (n >= N) continue;
#pragma unroll
        for (int v = 0; v < TP; ++v) {
          const int p = tx + kGrid * v;
          if (p < P) hs[n * P + p] = el * hs[n * P + p] + acc[u][v];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) a.h[bh * N * P + i] = hs[i];
}

template <typename T, int TP>
cudaError_t launch_ssd(const SsdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(a.chunk, a.n, a.p, a.wi);
  // above 48 KB only after opting in; raise the limit as larger shapes come
  static size_t attr_bytes = 0;
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_scan<T, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  const dim3 grid(a.nh, batch);
  ssd_chunk_scan<T, TP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const SsdArgs& a, int batch, cudaStream_t stream) {
  if (a.p <= 2 * kGrid) return launch_ssd<T, 2>(a, batch, stream);
  if (a.p <= 4 * kGrid) return launch_ssd<T, 4>(a, batch, stream);
  return launch_ssd<T, 8>(a, batch, stream);
}

}  // namespace

// Shared memory of one block for chunk L, state N, head dim P, W row tile wi.
extern "C" int rt_ssd_scan_smem(int chunk, int n, int p, int wi) {
  return static_cast<int>(sizeof(float)) * ssd_smem_floats(chunk, n, p, wi);
}

// strides: 10 int64 values: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq).
extern "C" int rt_ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
                           const void* cm, const float* h0, float* y, float* h,
                           const int64_t* strides, int batch, int s, int nh, int p, int n,
                           int chunk, int wi, int is_bf16, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (chunk < 1 || chunk > kMaxDim || n < 1 || n > kMaxDim || p < 1 || p > kMaxDim ||
      wi < 1 || wi > chunk || s < 0)
    return cudaErrorInvalidValue;
  SsdArgs args{x, dt, a, bm, cm, h0, y, h,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9],
               s, nh, p, n, chunk, wi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_p<__nv_bfloat16>(args, batch, st) : dispatch_p<float>(args, batch, st);
}
