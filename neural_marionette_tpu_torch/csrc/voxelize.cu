// Point cloud -> binary occupancy grid (kernel K1 of the port).
//
// Replaces: neural_marionette_tpu/ops/pallas/voxelize_kernel.py,
//   voxelize_pallas / _voxelize_kernel (a one-hot MXU contraction per frame,
//   the TPU's way around having no scatter; it does not carry over).
//
// Semantics (voxelize_jnp / voxelize_pallas): for every point p of frame f,
//   idx_a = floor((p_a - (-1)) / step), step = float32(2/G + 1e-5),
// computed with a true IEEE division (built without --use_fast_math), and
//   out[f, ix, iy, iz] = 1, linear index (ix * G + iy) * G + iz,
// when all three indices lie in [0, G); a point out of range on ANY axis is
// dropped (the test runs on the floored float, before any conversion to
// int, so padding values, NaN and +-inf are dropped too); duplicates give 1;
// every other voxel is 0.
//
// Bound on the H100: bytes. The grid (F * G^3 elements) is written once and
// the points (12 bytes each) read once; the arithmetic is a handful of float
// operations per point. At the serving shape (40 frames of 4096 points,
// G = 64, bfloat16) that is 21 MB of grid against 2 MB of points.
//
// Design: one launch that writes every byte of the grid exactly once, so
// the wrapper allocates the output with torch.empty and no fill runs.
//   * SLABS blocks per frame. Block s owns the contiguous voxel range
//     [s * chunk, min((s + 1) * chunk, G^3)), chunk = G^3 / SLABS rounded up
//     to whole 32-bit words, as a bitmask in its shared memory (4 KB at
//     G = 64). A range may be empty (G = 5: 125 voxels fill four words, so
//     blocks 4..7 own nothing).
//   * Every block reads all of its frame's points (the first block to touch
//     them brings them into L2, the others read them there), eight in
//     flight per thread, computes each point's cell and sets the bits of
//     its own range with shared-memory atomics.
//   * After __syncthreads(), the block expands its mask into the output with
//     16-byte stores (8 bfloat16 or 4 float32 values each). Elements before
//     the first 16-byte-aligned address of the range and after the last
//     whole store use scalar stores: ragged ranges (G = 5), frames whose
//     output does not start on a 16-byte boundary (a G = 5 bfloat16 frame is
//     250 bytes), and a caller's buffer at any offset.
// No atomics touch device memory and no value depends on the order of the
// points, so the output is the same bits on every run.
// What holds it above the bound: a block's writes cannot start before it
// has seen every point of its frame, and that phase is bound by the eight
// blocks' reads of the same points from L2. Fewer blocks per frame read
// less but leave SMs without stores; a cluster of blocks per frame that
// reads each point once and shares the cells through distributed shared
// memory was slower (PERF.md, scripts/voxelize_ablation.py).
#include <cuda_runtime.h>
#include <stdint.h>

#define SLABS 8          // blocks per frame
#define THREADS 512      // threads per block
#define UNROLL 8         // points in flight per thread
#define STORE_BYTES 16   // bytes per vector store
#define MAX_SMEM (227 * 1024)

// Voxels a block owns: G^3 / SLABS rounded up to a multiple of 32.
__host__ __device__ __forceinline__ int block_voxels(int G3) {
  int per = (G3 + SLABS - 1) / SLABS;
  return (per + 31) / 32 * 32;
}

// bits 0..n-1 of the mask starting at bit o (the word after the last one of
// the range is a zero pad, so the window never reads past the mask)
__device__ __forceinline__ unsigned int mask_bits(const unsigned int* mask,
                                                  int o) {
  unsigned long long lo = mask[o >> 5];
  unsigned long long hi = mask[(o >> 5) + 1];
  return (unsigned int)(((hi << 32) | lo) >> (o & 31));
}

// 16 bytes of output from the low values_per_store bits of b
template <int ES>
__device__ __forceinline__ uint4 expand(unsigned int b);

template <>
__device__ __forceinline__ uint4 expand<4>(unsigned int b) {  // float32
  const unsigned int one = 0x3F800000u;
  return make_uint4((b & 1u) ? one : 0u, (b & 2u) ? one : 0u,
                    (b & 4u) ? one : 0u, (b & 8u) ? one : 0u);
}

template <>
__device__ __forceinline__ uint4 expand<2>(unsigned int b) {  // bfloat16
  const unsigned int lo = 0x3F80u, hi = 0x3F800000u;
  return make_uint4(((b & 1u) ? lo : 0u) | ((b & 2u) ? hi : 0u),
                    ((b & 4u) ? lo : 0u) | ((b & 8u) ? hi : 0u),
                    ((b & 16u) ? lo : 0u) | ((b & 32u) ? hi : 0u),
                    ((b & 64u) ? lo : 0u) | ((b & 128u) ? hi : 0u));
}

template <int ES>
__device__ __forceinline__ void store_scalar(char* out, int64_t e, bool on) {
  if (ES == 4) {
    reinterpret_cast<unsigned int*>(out)[e] = on ? 0x3F800000u : 0u;
  } else {
    reinterpret_cast<unsigned short*>(out)[e] = on ? 0x3F80u : 0u;
  }
}

// ES: bytes per output element (4 float32, 2 bfloat16)
template <int ES>
__global__ void __launch_bounds__(THREADS)
voxelize_kernel(const float* __restrict__ pts, char* __restrict__ out,
                int n_points, int G, float step) {
  extern __shared__ unsigned int mask[];
  const int64_t frame = blockIdx.x / SLABS;
  const int slab = blockIdx.x % SLABS;
  const int G3 = G * G * G;
  const int chunk = block_voxels(G3);
  const int words = chunk / 32 + 1;  // one zero pad word
  const int v0 = min(slab * chunk, G3);
  const int n = min(v0 + chunk, G3) - v0;
  const int tid = threadIdx.x;

  for (int i = tid; i < words; i += THREADS) mask[i] = 0u;
  __syncthreads();

  // every point of the frame; the bits of this block's range
  const float* fp = pts + frame * n_points * 3;
  const float fG = (float)G;
  for (int i0 = 0; n > 0 && i0 < n_points; i0 += THREADS * UNROLL) {
    float x[UNROLL], y[UNROLL], z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS + tid;
      x[u] = y[u] = z[u] = __int_as_float(0x7fc00000);  // NaN: dropped
      if (i < n_points) {
        const float* p = fp + (int64_t)i * 3;
        x[u] = p[0];
        y[u] = p[1];
        z[u] = p[2];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float fx = floorf((x[u] + 1.0f) / step);
      float fy = floorf((y[u] + 1.0f) / step);
      float fz = floorf((z[u] + 1.0f) / step);
      bool ok = fx >= 0.0f && fx < fG && fy >= 0.0f && fy < fG &&
                fz >= 0.0f && fz < fG;  // NaN fails every comparison
      if (!ok) continue;
      int local = ((int)fx * G + (int)fy) * G + (int)fz - v0;
      if ((unsigned int)local < (unsigned int)n) {
        atomicOr(mask + (local >> 5), 1u << (local & 31));
      }
    }
  }
  __syncthreads();  // every bit of this block's range is set

  // expand [v0, v0 + n) of the frame into the output
  char* base = out + (frame * G3 + v0) * ES;  // element v0 of the frame
  const int per_store = STORE_BYTES / ES;
  const int mis = (int)(reinterpret_cast<uintptr_t>(base) & (STORE_BYTES - 1));
  const int head = min(n, ((STORE_BYTES - mis) & (STORE_BYTES - 1)) / ES);
  const int n_vec = (n - head) / per_store;
  const int tail0 = head + n_vec * per_store;
  const unsigned int sel = (1u << per_store) - 1u;
  uint4* vec = reinterpret_cast<uint4*>(base + head * ES);
  for (int j = tid; j < n_vec; j += THREADS) {
    unsigned int b = mask_bits(mask, head + j * per_store) & sel;
    vec[j] = expand<ES>(b);
  }
  // the scalar head [0, head) and tail [tail0, n): fewer than 2 * per_store
  const int n_scalar = head + (n - tail0);
  for (int s = tid; s < n_scalar; s += THREADS) {
    int o = s < head ? s : tail0 + (s - head);
    store_scalar<ES>(base, o, (mask[o >> 5] >> (o & 31)) & 1u);
  }
}

extern "C" {

// pts: (n_frames, n_points, 3) float32, contiguous. out: (n_frames, G^3)
// float32 (out_bf16 == 0) or bfloat16 (out_bf16 == 1), contiguous, any
// contents: every element is written. Returns cudaGetLastError() after the
// launch.
int nm_voxelize(const void* pts, void* out, int out_bf16, long long n_frames,
                int n_points, int G, float step, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_frames == 0) return (int)cudaSuccess;
  if (n_frames > (long long)(0x7fffffff / SLABS) || G < 1 || G > 1024 ||
      n_points < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(block_voxels(G * G * G) / 32 + 1) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;  // G > 245
  void (*kernel)(const float*, char*, int, int, float) =
      out_bf16 ? voxelize_kernel<2> : voxelize_kernel<4>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned int)(n_frames * SLABS), THREADS, smem,
           (cudaStream_t)stream>>>((const float*)pts, (char*)out, n_points,
                                   G, step);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
