// Chamfer volume-fitting numerator, forward (kernel K2 of the port).
//
// Replaces: neural_marionette_tpu/ops/pallas/chamfer_kernel.py,
//   chamfer_num_pallas forward (_chamfer_fwd / _chamfer_fwd_kernel).
//
// Per frame m, over the G^3 voxel centres v of the linspace(-1, 1, G) grid
// (raveled x-major, as occ.reshape(M, G^3)) and the K keypoints c_k:
//   num[m] = sum_v occ[m, v] * relu(|v|^2 + min_k(|c_k|^2 - 2 v.c_k))
// with the same expansion as the JAX paths.
//
// Bound on the H100: bytes, one read of the occupancy grid. An empty voxel
// adds exactly 0, so the work the inputs need is the min over keypoints at
// the occupied voxels only (four fp32 fused multiply-adds and a min per
// voxel-keypoint pair, on the CUDA cores: the contraction depth is 3),
// and a serving frame occupies at most N of its G^3 voxels.
// This kernel does not reach that bound: it evaluates the min at every
// voxel, occupied or not: at N=4096 points and G=64, at least 64 times the
// operations the serving inputs need. A kernel that visits only occupied voxels is later
// work.
// Design: pass 1 runs blocks over (voxel tile, frame). The frame's K
// keypoints and their |c|^2 sit in shared memory; each thread takes
// VOX_PER_THREAD voxels, reads their coordinates from the per-axis
// linspace table, keeps a running min over k, applies relu, multiplies by
// the occupancy (float32 or bfloat16) and accumulates. A block reduction
// writes one partial per (frame, tile). Pass 2 sums each frame's partials
// in a fixed order, so no float atomics are used and two runs agree to the
// bit. K is not padded: the loop runs over the real keypoints.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define VOX_PER_THREAD 4
#define MAX_K 64

__device__ __forceinline__ float load_occ(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_occ(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;  // valid in thread 0 only
}

template <typename T>
__global__ void chamfer_partial_kernel(const float* __restrict__ kp,
                                       const T* __restrict__ occ,
                                       const float* __restrict__ lin,
                                       float* __restrict__ partial, int K,
                                       int G, int n_tiles) {
  __shared__ float s_kp[MAX_K * 3];
  __shared__ float s_c2[MAX_K];
  __shared__ float s_red[THREADS / 32];
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float x0 = kp[((int64_t)m * K + k) * 3 + 0];
    float x1 = kp[((int64_t)m * K + k) * 3 + 1];
    float x2 = kp[((int64_t)m * K + k) * 3 + 2];
    s_kp[k * 3 + 0] = x0;
    s_kp[k * 3 + 1] = x1;
    s_kp[k * 3 + 2] = x2;
    s_c2[k] = x0 * x0 + x1 * x1 + x2 * x2;
  }
  __syncthreads();

  const int64_t G3 = (int64_t)G * G * G;
  const T* occ_m = occ + (int64_t)m * G3;
  const int64_t base = (int64_t)tile * THREADS * VOX_PER_THREAD;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < VOX_PER_THREAD; ++j) {
    int64_t v = base + (int64_t)j * THREADS + threadIdx.x;
    if (v >= G3) break;
    int ix = (int)(v / ((int64_t)G * G));
    int iy = (int)((v / G) % G);
    int iz = (int)(v % G);
    float vx = lin[ix], vy = lin[iy], vz = lin[iz];
    float v2 = vx * vx + vy * vy + vz * vz;
    float best = __int_as_float(0x7f800000);  // +inf
    for (int k = 0; k < K; ++k) {
      float val = s_c2[k] - 2.0f * (s_kp[k * 3 + 0] * vx +
                                    s_kp[k * 3 + 1] * vy +
                                    s_kp[k * 3 + 2] * vz);
      best = fminf(best, val);
    }
    float dmin = fmaxf(v2 + best, 0.0f);
    acc += load_occ(occ_m, v) * dmin;
  }
  float total = block_sum(acc, s_red);
  if (threadIdx.x == 0) partial[(int64_t)m * n_tiles + tile] = total;
}

__global__ void chamfer_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ num, int n_tiles) {
  __shared__ float s_red[THREADS / 32];
  const int m = blockIdx.x;
  float acc = 0.0f;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    acc += partial[(int64_t)m * n_tiles + t];
  float total = block_sum(acc, s_red);
  if (threadIdx.x == 0) num[m] = total;
}

extern "C" {

// Voxels per block of pass 1; the wrapper sizes the partial buffer with it.
int nm_chamfer_tile_voxels() { return THREADS * VOX_PER_THREAD; }

int nm_chamfer_max_k() { return MAX_K; }

// kp: (M, K, 3) float32; occ: (M, G^3) float32 (occ_bf16 == 0) or
// bfloat16 (occ_bf16 == 1); lin: (G,) float32 linspace(-1, 1, G);
// partial: (M, n_tiles) float32 scratch; num: (M,) float32 output.
// Returns cudaGetLastError() after the two launches.
int nm_chamfer_fwd(const void* kp, const void* occ, int occ_bf16,
                   const void* lin, void* partial, void* num, int M, int K,
                   int G, int n_tiles, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (M == 0) return (int)cudaSuccess;
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid1((unsigned int)n_tiles, (unsigned int)M);
  if (occ_bf16) {
    chamfer_partial_kernel<__nv_bfloat16><<<grid1, THREADS, 0, s>>>(
        (const float*)kp, (const __nv_bfloat16*)occ, (const float*)lin,
        (float*)partial, K, G, n_tiles);
  } else {
    chamfer_partial_kernel<float><<<grid1, THREADS, 0, s>>>(
        (const float*)kp, (const float*)occ, (const float*)lin,
        (float*)partial, K, G, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_sum_kernel<<<(unsigned int)M, THREADS, 0, s>>>(
      (const float*)partial, (float*)num, n_tiles);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
