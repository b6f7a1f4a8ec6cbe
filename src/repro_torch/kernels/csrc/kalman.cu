// kalman_scan: the scalar Kalman filter of the riot `kalman` operator,
// one thread per channel, rows in sequence.
//
// A helper of the stream path, not a port of a TPU kernel: the reference
// runs this recurrence as a row-sequential lax.scan (repro/ops/riot.py,
// `kalman`). Its xe recurrence is sequential, so the dependent chain of
// one row (add, divide, multiply, add) times the row count bounds it, not
// memory; a torch loop would cost several launches per row instead. Every
// operation is a _rn intrinsic, so the result is bitwise the plain
// version's (kernels/ref.py:kalman_scan_ref).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kalman_scan_kernel(const float* __restrict__ z, int64_t stride,
                                   const float* __restrict__ xe0, const float* __restrict__ p0,
                                   float* __restrict__ y, float* __restrict__ xe1,
                                   float* __restrict__ p1, int64_t rows, int channels, float q,
                                   float r) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= channels) return;
  float xe = xe0[ch];
  float p = p0[ch];
  for (int64_t i = 0; i < rows; ++i) {
    const float p_pred = __fadd_rn(p, q);
    const float k = __fdiv_rn(p_pred, __fadd_rn(p_pred, r));
    xe = __fadd_rn(xe, __fmul_rn(k, __fsub_rn(z[i * stride + ch], xe)));
    p = __fmul_rn(__fsub_rn(1.0f, k), p_pred);
    y[i * channels + ch] = xe;
  }
  xe1[ch] = xe;
  p1[ch] = p;
}

}  // namespace

extern "C" int rt_kalman_scan(const float* z, int64_t stride, const float* xe0, const float* p0,
                              float* y, float* xe1, float* p1, int64_t rows, int channels,
                              float q, float r, void* stream) {
  if (channels <= 0) return cudaSuccess;
  const int threads = 128;
  kalman_scan_kernel<<<(channels + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      z, stride, xe0, p0, y, xe1, p1, rows, channels, q, r);
  return cudaGetLastError();
}
