// Point cloud -> binary occupancy grid (kernel K1 of the port).
//
// Replaces: neural_marionette_tpu/ops/pallas/voxelize_kernel.py,
//   voxelize_pallas / _voxelize_kernel (a one-hot MXU contraction per frame).
//
// Semantics (voxelize_jnp / voxelize_pallas): for every point p of frame f,
//   idx_a = floor((p_a - (-1)) / step), step = float32(2/G + 1e-5),
// computed with a true IEEE division (built without --use_fast_math), and
//   out[f, ix, iy, iz] = 1
// when all three indices lie in [0, G); a point out of range on ANY axis is
// dropped. Duplicate points write the same value, so races are benign.
//
// Bound on the H100: bytes. The kernel reads 12 bytes per point and the
// caller's output grid (F * G^3 elements, zeroed by the wrapper) dominates
// the traffic; the arithmetic is a handful of float ops per point.
// Design: one thread per point, a plain store of 1 into the zeroed grid.
// The TPU's one-hot matmul was a workaround for the lack of a scatter and
// does not carry over. The range check runs on the floored float, before
// any conversion to int: out-of-range and padding values (1e9) saturate
// differently in a C++ cast.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ T one_value();
template <>
__device__ __forceinline__ float one_value<float>() { return 1.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 one_value<__nv_bfloat16>() {
  return __float2bfloat16(1.0f);
}

template <typename T>
__global__ void voxelize_kernel(const float* __restrict__ pts,
                                T* __restrict__ out, int64_t n_total,
                                int n_points, int G, float step) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_total) return;
  int64_t frame = i / n_points;
  const float* p = pts + i * 3;
  const float fG = (float)G;
  float fx = floorf((p[0] + 1.0f) / step);
  float fy = floorf((p[1] + 1.0f) / step);
  float fz = floorf((p[2] + 1.0f) / step);
  bool ok = fx >= 0.0f && fx < fG && fy >= 0.0f && fy < fG &&
            fz >= 0.0f && fz < fG;  // NaN fails every comparison
  if (!ok) return;
  int64_t G3 = (int64_t)G * G * G;
  int64_t lin = ((int64_t)fx * G + (int64_t)fy) * G + (int64_t)fz;
  out[frame * G3 + lin] = one_value<T>();
}

extern "C" {

// pts: (n_frames, n_points, 3) float32, contiguous. out: (n_frames, G^3),
// zeroed, float32 (out_bf16 == 0) or bfloat16 (out_bf16 == 1).
// Returns cudaGetLastError() after the launch.
int nm_voxelize(const void* pts, void* out, int out_bf16, long long n_frames,
                int n_points, int G, float step, int device,
                void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int64_t n_total = (int64_t)n_frames * n_points;
  if (n_total == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((n_total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    voxelize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const float*)pts, (__nv_bfloat16*)out, n_total, n_points, G, step);
  } else {
    voxelize_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)pts, (float*)out, n_total, n_points, G, step);
  }
  return (int)cudaGetLastError();
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
