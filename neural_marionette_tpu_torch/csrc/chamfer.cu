// Chamfer volume-fitting numerator, forward and backward (kernel K2 of the
// port).
//
// Replaces: neural_marionette_tpu/ops/pallas/chamfer_kernel.py,
//   chamfer_num_pallas forward (_chamfer_fwd / _chamfer_fwd_kernel) and
//   backward (_chamfer_bwd / _chamfer_bwd_kernel).
//
// Per frame m, over the G^3 voxel centres v of the linspace(-1, 1, G) grid
// (raveled x-major, as occ.reshape(M, G^3)) and the K keypoints c_k:
//   val_k(v) = |c_k|^2 - 2 v.c_k,  dmin(v) = |v|^2 + min_k val_k(v)
//   num[m]   = sum_v occ[m, v] * relu(dmin(v))
// and, for an upstream gradient g[m], with JAX's VJP conventions (relu' is
// 1 above 0, 1/2 at exactly 0, 0 below; a tie among the minima over k
// splits the gradient equally among the tied k):
//   W_k(v)    = g * occ[v] * relu'(dmin(v)) * [val_k(v) == min] / ties(v)
//   dkp[m, k] = 2 c_k S_k - 2 P_k,  S_k = sum_v W_k(v),  P_k = sum_v W_k(v) v
//   docc[m,v] = g * relu(dmin(v))   (only when the occupancy needs a gradient)
// val_k, |c|^2 and |v|^2 are computed by one device function each, with
// explicit round-to-nearest intrinsics, so the backward's tie test sees the
// very bits the forward's min saw.
//
// Bound on the H100: bytes, one read of the occupancy grid. An empty voxel
// adds exactly 0 to num and to dkp, so the work the inputs need is the min
// over keypoints at the occupied voxels only (four fp32 fused multiply-adds
// and a min per voxel-keypoint pair, on the CUDA cores: the contraction
// depth is 3), and a frame of N points occupies at most N of its G^3
// voxels. With docc the backward also writes the whole grid and needs dmin
// at every voxel: then it is operation-bound.
// The forward does not reach its bound: it evaluates the min at every voxel,
// occupied or not. The backward without docc evaluates it at occupied
// voxels only, and skips whole warps and blocks with nothing to add.
//
// Design (both directions): pass 1 runs blocks over (voxel tile, frame).
// The frame's K keypoints and their |c|^2 sit in shared memory; each thread
// takes VOX_PER_THREAD voxels and reads their coordinates from the per-axis
// linspace table. The forward keeps a running min over k, applies relu,
// multiplies by the occupancy (float32 or bfloat16) and block-reduces one
// partial per (frame, tile). The backward keeps each voxel's min, tie count
// and weight in registers, then for each k warp-reduces (S_k, P_k) and
// sums the warps in a fixed order into one partial per (frame, tile, k).
// Pass 2 sums each frame's partials over the tiles in a fixed order (and
// the backward forms 2 c_k S_k - 2 P_k). No float atomics are used, so two
// runs agree to the bit. K is not padded: the loops run over the real
// keypoints (the TPU kernel's pad-to-8 with 1e9 sentinels does not carry
// over).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define VOX_PER_THREAD 4
#define MAX_K 64

__device__ __forceinline__ float load_occ(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_occ(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_occ(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_occ(__nv_bfloat16* p, int64_t i,
                                          float x) {
  p[i] = __float2bfloat16_rn(x);
}

// |a|^2 for a 3-vector, rounding fixed by the intrinsics.
__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a)));
}

// val_k(v) = |c_k|^2 - 2 v.c_k (2 v.c is exact from v.c).
__device__ __forceinline__ float chamfer_val(const float* s_kp,
                                             const float* s_c2, int k,
                                             float vx, float vy, float vz) {
  float d = __fmaf_rn(s_kp[k * 3 + 2], vz,
                      __fmaf_rn(s_kp[k * 3 + 1], vy,
                                __fmul_rn(s_kp[k * 3 + 0], vx)));
  return __fmaf_rn(-2.0f, d, s_c2[k]);
}

// The frame's keypoints and |c|^2 into shared memory (ends with a barrier).
__device__ __forceinline__ void load_keypoints(const float* kp, int m, int K,
                                               float* s_kp, float* s_c2) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float x0 = kp[((int64_t)m * K + k) * 3 + 0];
    float x1 = kp[((int64_t)m * K + k) * 3 + 1];
    float x2 = kp[((int64_t)m * K + k) * 3 + 2];
    s_kp[k * 3 + 0] = x0;
    s_kp[k * 3 + 1] = x1;
    s_kp[k * 3 + 2] = x2;
    s_c2[k] = sq3(x0, x1, x2);
  }
  __syncthreads();
}

__device__ __forceinline__ void voxel_coords(const float* lin, int64_t v,
                                             int G, float* vx, float* vy,
                                             float* vz) {
  *vx = lin[(int)(v / ((int64_t)G * G))];
  *vy = lin[(int)((v / G) % G)];
  *vz = lin[(int)(v % G)];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // valid in lane 0
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;  // valid in thread 0 only
}

// ------------------------------------------------------------------ forward
template <typename T>
__global__ void chamfer_partial_kernel(const float* __restrict__ kp,
                                       const T* __restrict__ occ,
                                       const float* __restrict__ lin,
                                       float* __restrict__ partial, int K,
                                       int G, int n_tiles) {
  __shared__ float s_kp[MAX_K * 3];
  __shared__ float s_c2[MAX_K];
  __shared__ float s_red[WARPS];
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  load_keypoints(kp, m, K, s_kp, s_c2);

  const int64_t G3 = (int64_t)G * G * G;
  const T* occ_m = occ + (int64_t)m * G3;
  const int64_t base = (int64_t)tile * THREADS * VOX_PER_THREAD;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < VOX_PER_THREAD; ++j) {
    int64_t v = base + (int64_t)j * THREADS + threadIdx.x;
    if (v >= G3) break;
    float vx, vy, vz;
    voxel_coords(lin, v, G, &vx, &vy, &vz);
    float best = __int_as_float(0x7f800000);  // +inf
    for (int k = 0; k < K; ++k)
      best = fminf(best, chamfer_val(s_kp, s_c2, k, vx, vy, vz));
    float dmin = fmaxf(__fadd_rn(sq3(vx, vy, vz), best), 0.0f);
    acc += load_occ(occ_m, v) * dmin;
  }
  float total = block_sum(acc, s_red);
  if (threadIdx.x == 0) partial[(int64_t)m * n_tiles + tile] = total;
}

__global__ void chamfer_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ num, int n_tiles) {
  __shared__ float s_red[WARPS];
  const int m = blockIdx.x;
  float acc = 0.0f;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    acc += partial[(int64_t)m * n_tiles + t];
  float total = block_sum(acc, s_red);
  if (threadIdx.x == 0) num[m] = total;
}

// ----------------------------------------------------------------- backward
// partial: (M, n_tiles, K, 4) float32, (S_k, P_k.x, P_k.y, P_k.z) of the
// tile's voxels. docc: (M, G^3) in the occupancy's type, written when
// WANT_DOCC.
template <typename T, bool WANT_DOCC>
__global__ void chamfer_bwd_partial_kernel(const float* __restrict__ g,
                                           const float* __restrict__ kp,
                                           const T* __restrict__ occ,
                                           const float* __restrict__ lin,
                                           float* __restrict__ partial,
                                           T* __restrict__ docc, int K,
                                           int G, int n_tiles) {
  __shared__ float s_kp[MAX_K * 3];
  __shared__ float s_c2[MAX_K];
  __shared__ float s_red[WARPS][MAX_K * 4];
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_keypoints(kp, m, K, s_kp, s_c2);

  const int64_t G3 = (int64_t)G * G * G;
  const T* occ_m = occ + (int64_t)m * G3;
  const int64_t base = (int64_t)tile * THREADS * VOX_PER_THREAD;
  const float gm = g[m];
  float w[VOX_PER_THREAD], best[VOX_PER_THREAD];
  float px[VOX_PER_THREAD], py[VOX_PER_THREAD], pz[VOX_PER_THREAD];
  bool mine = false;  // does any of this thread's voxels carry a weight?
#pragma unroll
  for (int j = 0; j < VOX_PER_THREAD; ++j) {
    int64_t v = base + (int64_t)j * THREADS + threadIdx.x;
    w[j] = 0.0f;
    best[j] = 0.0f;
    px[j] = py[j] = pz[j] = 0.0f;
    if (v < G3) {
      float o = load_occ(occ_m, v);
      if (WANT_DOCC || o != 0.0f) {
        voxel_coords(lin, v, G, &px[j], &py[j], &pz[j]);
        float b = __int_as_float(0x7f800000);  // +inf
        float ties = 0.0f;
        for (int k = 0; k < K; ++k) {
          float val = chamfer_val(s_kp, s_c2, k, px[j], py[j], pz[j]);
          if (val < b) {
            b = val;
            ties = 1.0f;
          } else if (val == b) {
            ties += 1.0f;
          }
        }
        float dmin = __fadd_rn(sq3(px[j], py[j], pz[j]), b);
        if (WANT_DOCC) {
          store_occ(docc + (int64_t)m * G3, v, gm * fmaxf(dmin, 0.0f));
        }
        float relu_w = dmin > 0.0f ? 1.0f : (dmin == 0.0f ? 0.5f : 0.0f);
        w[j] = (gm * o * relu_w) / ties;
        best[j] = b;
        mine = mine || (w[j] != 0.0f);
      }
    }
  }

  // a block with nothing to add writes zeros and stops (uniform branch)
  float* out = partial + ((int64_t)m * n_tiles + tile) * K * 4;
  if (!__syncthreads_or(mine)) {
    for (int i = threadIdx.x; i < K * 4; i += blockDim.x) out[i] = 0.0f;
    return;
  }
  if (__any_sync(0xffffffffu, mine)) {
    for (int k = 0; k < K; ++k) {
      float s = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
      for (int j = 0; j < VOX_PER_THREAD; ++j) {
        if (w[j] != 0.0f &&
            chamfer_val(s_kp, s_c2, k, px[j], py[j], pz[j]) == best[j]) {
          s += w[j];
          sx += w[j] * px[j];
          sy += w[j] * py[j];
          sz += w[j] * pz[j];
        }
      }
      s = warp_sum(s);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      sz = warp_sum(sz);
      if (lane == 0) {
        s_red[warp][k * 4 + 0] = s;
        s_red[warp][k * 4 + 1] = sx;
        s_red[warp][k * 4 + 2] = sy;
        s_red[warp][k * 4 + 3] = sz;
      }
    }
  } else {
    for (int i = lane; i < K * 4; i += 32) s_red[warp][i] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * 4; i += blockDim.x) {
    float acc = 0.0f;
    for (int wp = 0; wp < WARPS; ++wp) acc += s_red[wp][i];
    out[i] = acc;
  }
}

// One block per frame: sums the tiles' partials in tile order and writes
// dkp[m, k, a] = 2 c_k[a] S_k - 2 P_k[a].
__global__ void chamfer_bwd_sum_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ kp,
                                       float* __restrict__ dkp, int K,
                                       int n_tiles) {
  __shared__ float s_sum[MAX_K * 4];
  const int m = blockIdx.x;
  const int64_t stride = (int64_t)K * 4;
  const float* p = partial + (int64_t)m * n_tiles * stride;
  for (int i = threadIdx.x; i < K * 4; i += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < n_tiles; ++t) acc += p[t * stride + i];
    s_sum[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * 3; i += blockDim.x) {
    int k = i / 3, a = i % 3;
    float c = kp[(int64_t)m * K * 3 + i];
    dkp[(int64_t)m * K * 3 + i] =
        2.0f * c * s_sum[k * 4] - 2.0f * s_sum[k * 4 + 1 + a];
  }
}

extern "C" {

// Voxels per block of pass 1; the wrapper sizes the partial buffers with it.
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

// g: (M,) float32 upstream gradient; kp, occ, occ_bf16, lin as for the
// forward; partial: (M, n_tiles, K, 4) float32 scratch; dkp: (M, K, 3)
// float32 output; docc: (M, G^3) in the occupancy's type, or null when the
// occupancy needs no gradient. Returns cudaGetLastError() after the two
// launches.
int nm_chamfer_bwd(const void* g, const void* kp, const void* occ,
                   int occ_bf16, const void* lin, void* partial, void* dkp,
                   void* docc, int M, int K, int G, int n_tiles, int device,
                   void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (M == 0) return (int)cudaSuccess;
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid1((unsigned int)n_tiles, (unsigned int)M);
  const float* gf = (const float*)g;
  const float* kpf = (const float*)kp;
  const float* linf = (const float*)lin;
  float* pf = (float*)partial;
  if (occ_bf16) {
    const __nv_bfloat16* o = (const __nv_bfloat16*)occ;
    __nv_bfloat16* d = (__nv_bfloat16*)docc;
    if (docc) {
      chamfer_bwd_partial_kernel<__nv_bfloat16, true>
          <<<grid1, THREADS, 0, s>>>(gf, kpf, o, linf, pf, d, K, G, n_tiles);
    } else {
      chamfer_bwd_partial_kernel<__nv_bfloat16, false>
          <<<grid1, THREADS, 0, s>>>(gf, kpf, o, linf, pf, d, K, G, n_tiles);
    }
  } else {
    const float* o = (const float*)occ;
    float* d = (float*)docc;
    if (docc) {
      chamfer_bwd_partial_kernel<float, true>
          <<<grid1, THREADS, 0, s>>>(gf, kpf, o, linf, pf, d, K, G, n_tiles);
    } else {
      chamfer_bwd_partial_kernel<float, false>
          <<<grid1, THREADS, 0, s>>>(gf, kpf, o, linf, pf, d, K, G, n_tiles);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_bwd_sum_kernel<<<(unsigned int)M, THREADS, 0, s>>>(
      pf, kpf, (float*)dkp, K, n_tiles);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
