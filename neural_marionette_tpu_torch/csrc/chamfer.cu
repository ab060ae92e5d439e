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
// Bound on the H100: bytes, one read of the occupancy grid (at the serving
// shape, 40 frames of 64^3 bfloat16, 21 MB: 0.0063 ms at 3.35 TB/s). An
// empty voxel adds exactly 0 to num and to dkp, so the work the inputs need
// is the min over keypoints at the occupied voxels only (four fp32 fused
// multiply-adds and a min per voxel-keypoint pair, on the CUDA cores: the
// contraction depth is 3), and a frame of N points occupies at most N of
// its G^3 voxels (1.6 % at N = 4096, G = 64). With docc the backward also
// writes the whole grid and needs dmin at every voxel: that part is
// operation-bound by nature.
//
// Design: the work follows the occupied voxels, not the grid. One launch
// per direction; a block owns a tile of TILE_VOXELS voxels of one frame.
// 1. Load and compact (both directions, compact_tile): each thread reads
//    its share of the tile with 16-byte loads (8 bfloat16 or 4 float32
//    values; scalar loads where the frame's row is not 16-byte aligned or
//    the tile is ragged, as for G = 5), stages the frame's keypoints while
//    the loads are in flight, and the block gathers the nonzero voxels into
//    shared memory in voxel order (per-thread popcounts, a warp scan and a
//    block prefix): the 32-bit in-frame index and the value.
// 2. Forward: all threads evaluate the compacted voxels densely, two per
//    pass over the keypoints, the coordinates from the per-axis linspace
//    table by 32-bit index arithmetic, and block-reduce one partial per
//    tile.
// 3. Backward, in rounds of CHUNK compacted voxels: per voxel, one pass
//    over k gives the min, a 64-bit mask of the keypoints equal to it
//    (MAX_K = 64), ties = popc(mask), relu' and the weight w, kept in
//    shared memory as (w, w v). Then thread (k, segment) sums them over its
//    segment's voxels whose mask has bit k (a 16-byte shared load and four
//    adds: the lanes of a warp take different k, so the branch is taken
//    for nearly every voxel a warp steps over, and its body must be
//    short), and the segments are summed in order: one partial (S_k, P_k)
//    per (tile, k).
// 4. The tile writes its partial; the frame's last block to finish (an
//    integer ticket taken after __threadfence) sums the frame's partials in
//    a fixed order, writes num[m] or dkp[m] = 2 c S - 2 P, and sets the
//    ticket back to 0 for the next launch. No float atomics, so two runs
//    agree to the bit. K is not padded: the loops run over the real
//    keypoints (the TPU kernel's pad-to-8 with 1e9 sentinels does not carry
//    over).
// docc comes from a separate dense elementwise kernel (chamfer_docc_kernel)
// with the same device functions; dkp is the sparse kernel's either way.
// Left: the forward does not hand its compacted list to the backward (each
// reads the grid again); a frame's last block sums its tiles' partials
// alone, a tail after the other blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define TILE_VOXELS 4096   // voxels of one frame per block
#define CHUNK 512          // backward: compacted voxels weighed per round
#define MAX_K 64           // a tie mask is one 64-bit word

// Access to the occupancy's type: VEC values per 16-byte word, a value by
// its position in the word (a constant once the loops are unrolled).
template <typename T>
struct Occ;

template <>
struct Occ<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float get(const uint4& q, int e) {
    return __uint_as_float(e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w);
  }
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Occ<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float get(const uint4& q, int e) {
    unsigned int w = e < 2 ? q.x : e < 4 ? q.y : e < 6 ? q.z : q.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ unsigned int bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(bits(x[0]) | bits(x[1]) << 16,
                      bits(x[2]) | bits(x[3]) << 16,
                      bits(x[4]) | bits(x[5]) << 16,
                      bits(x[6]) | bits(x[7]) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

static_assert(TILE_VOXELS % (THREADS * Occ<__nv_bfloat16>::VEC) == 0 &&
                  TILE_VOXELS / (THREADS * Occ<float>::VEC) <= 4,
              "a tile is whole rounds of 16-byte loads, at most four, whose "
              "counts share one 64-bit scan word");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// |a|^2 for a 3-vector, rounding fixed by the intrinsics.
__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a)));
}

// val_k(v) = |c_k|^2 - 2 v.c_k (2 v.c is exact from v.c); c = (c_k, |c_k|^2).
__device__ __forceinline__ float chamfer_val(float4 c, float vx, float vy,
                                             float vz) {
  float d = __fmaf_rn(c.z, vz, __fmaf_rn(c.y, vy, __fmul_rn(c.x, vx)));
  return __fmaf_rn(-2.0f, d, c.w);
}

__device__ __forceinline__ float min_val(const float4* s_kp, int K, float vx,
                                         float vy, float vz) {
  float best = __int_as_float(0x7f800000);  // +inf
  for (int k = 0; k < K; ++k)
    best = fminf(best, chamfer_val(s_kp[k], vx, vy, vz));
  return best;
}

// The frame's keypoints and |c|^2 into shared memory (no barrier).
__device__ __forceinline__ void stage_keypoints(const float* kp, int m, int K,
                                                float4* s_kp) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* c = kp + ((int64_t)m * K + k) * 3;
    s_kp[k] = make_float4(c[0], c[1], c[2], sq3(c[0], c[1], c[2]));
  }
}

// Voxel v's centre from the per-axis table, by 32-bit index arithmetic.
__device__ __forceinline__ void voxel_coords(const float* __restrict__ lin,
                                             unsigned int v, unsigned int G,
                                             float* vx, float* vy, float* vz) {
  const unsigned int xy = v / G;
  const unsigned int x = xy / G;
  *vz = __ldg(lin + (v - xy * G));
  *vy = __ldg(lin + (xy - x * G));
  *vx = __ldg(lin + x);
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
    for (int w = 0; w < WARPS; ++w) total += scratch[w];
  }
  return total;  // valid in thread 0 only
}

// Voxels [t0, t0 + TILE_VOXELS) of frame m's row of G3 values: gathers
// the nonzero ones into s_idx (in-frame index) and s_val (value) in voxel
// order, and stages the frame's keypoints in s_kp while the loads are in
// flight. In round r, thread j reads the VEC voxels from t0 + (r THREADS +
// j) VEC, with one 16-byte load where the whole tile lies in the row and
// starts 16-byte aligned. The per-round counts ride in 16-bit fields of one
// 64-bit word through a warp scan and a block prefix. Returns the count in
// every thread; ends with a barrier.
template <typename T>
__device__ __forceinline__ int compact_tile(
    const T* __restrict__ row, unsigned int G3, unsigned int t0,
    const float* kp, int m, int K, float4* s_kp, unsigned int* s_idx,
    float* s_val, unsigned long long* s_scan) {
  constexpr int VEC = Occ<T>::VEC;
  constexpr int ROUNDS = TILE_VOXELS / (THREADS * VEC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float val[ROUNDS][VEC];
  if (t0 + TILE_VOXELS <= G3 && aligned16(row + t0)) {
    uint4 q[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
      q[r] = __ldg(reinterpret_cast<const uint4*>(
          row + t0 + (r * THREADS + threadIdx.x) * VEC));
    stage_keypoints(kp, m, K, s_kp);
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) val[r][e] = Occ<T>::get(q[r], e);
  } else {
    stage_keypoints(kp, m, K, s_kp);
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        unsigned int v = t0 + (r * THREADS + threadIdx.x) * VEC + e;
        val[r][e] = v < G3 ? Occ<T>::load(row + v) : 0.0f;
      }
  }
  unsigned int bits[ROUNDS];
  unsigned long long mine = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    bits[r] = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (val[r][e] != 0.0f) bits[r] |= 1u << e;
    mine |= (unsigned long long)__popc(bits[r]) << (16 * r);
  }
  unsigned long long x = mine;  // inclusive warp scan, field by field
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  unsigned long long before = x - mine, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    unsigned long long s = s_scan[w];
    if (w < warp) before += s;
    total += s;
  }
  unsigned int base = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    unsigned int pos = base + (unsigned int)((before >> (16 * r)) & 0xffffu);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (bits[r] >> e & 1u) {
        s_idx[pos] = t0 + (r * THREADS + threadIdx.x) * VEC + e;
        s_val[pos] = val[r][e];
        ++pos;
      }
    }
    base += (unsigned int)((total >> (16 * r)) & 0xffffu);
  }
  __syncthreads();
  return (int)base;
}

// Called by every thread after its writes of the block's partial: true in
// every thread of the frame's last block to finish (uniform).
__device__ __forceinline__ bool last_of_frame(unsigned int* ticket,
                                              int n_tiles, int* s_last) {
  __threadfence();  // this thread's partial is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(ticket, 1u) == (unsigned int)(n_tiles - 1);
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last != 0;
}

// ------------------------------------------------------------------ forward
// partial: (M, n_tiles) float32; tickets: (M,) zero on entry and on exit.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    chamfer_fwd_kernel(const float* __restrict__ kp, const T* __restrict__ occ,
                       const float* __restrict__ lin, float* partial,
                       unsigned int* tickets, float* __restrict__ num, int K,
                       int G, int n_tiles) {
  __shared__ unsigned int s_idx[TILE_VOXELS];
  __shared__ float s_val[TILE_VOXELS];
  __shared__ float4 s_kp[MAX_K];
  __shared__ unsigned long long s_scan[WARPS];
  __shared__ float s_red[WARPS];
  __shared__ int s_last;
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  const unsigned int G3 = (unsigned int)G * G * G;
  const int n = compact_tile(occ + (int64_t)m * G3, G3, tile * TILE_VOXELS,
                             kp, m, K, s_kp, s_idx, s_val, s_scan);
  // thread j takes voxels j, j + THREADS, ... in order, two per pass over
  // the keypoints (one shared load of c_k serves both)
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += 2 * THREADS) {
    const int i1 = i + THREADS;
    const bool two = i1 < n;
    float ax, ay, az, bx, by, bz;
    voxel_coords(lin, s_idx[i], G, &ax, &ay, &az);
    voxel_coords(lin, s_idx[two ? i1 : i], G, &bx, &by, &bz);
    float best_a = __int_as_float(0x7f800000), best_b = best_a;  // +inf
    for (int k = 0; k < K; ++k) {
      const float4 c = s_kp[k];
      best_a = fminf(best_a, chamfer_val(c, ax, ay, az));
      best_b = fminf(best_b, chamfer_val(c, bx, by, bz));
    }
    acc = __fmaf_rn(s_val[i],
                    fmaxf(__fadd_rn(sq3(ax, ay, az), best_a), 0.0f), acc);
    if (two)
      acc = __fmaf_rn(s_val[i1],
                      fmaxf(__fadd_rn(sq3(bx, by, bz), best_b), 0.0f), acc);
  }
  float* pm = partial + (int64_t)m * n_tiles;
  const float total = block_sum(acc, s_red);
  if (threadIdx.x == 0) pm[tile] = total;
  if (!last_of_frame(tickets + m, n_tiles, &s_last)) return;
  float sum = 0.0f;
  for (int t = threadIdx.x; t < n_tiles; t += THREADS) sum += __ldcg(pm + t);
  sum = block_sum(sum, s_red);
  if (threadIdx.x == 0) {
    num[m] = sum;
    tickets[m] = 0;
  }
}

// ----------------------------------------------------------------- backward
// One keypoint's step of the backward's pass over k for a voxel: the min so
// far, and the mask of the keypoints equal to it (bit = 1 << k).
__device__ __forceinline__ void tie_step(float val, unsigned long long bit,
                                         float* best,
                                         unsigned long long* mask) {
  if (val < *best) {
    *best = val;
    *mask = bit;
  } else if (val == *best) {
    *mask |= bit;
  }
}

// A voxel's weight w = g occ relu'(dmin) / ties, kept as (w, w v) with the
// mask of its nearest keypoints (none when w is 0: it adds nothing).
__device__ __forceinline__ void weigh(float vx, float vy, float vz,
                                      float best, unsigned long long mask,
                                      float gm, float o, float4* w4,
                                      unsigned long long* w_mask) {
  const float dmin = __fadd_rn(sq3(vx, vy, vz), best);
  const float relu_w = dmin > 0.0f ? 1.0f : (dmin == 0.0f ? 0.5f : 0.0f);
  const float w = (gm * o * relu_w) / (float)__popcll(mask);
  *w4 = make_float4(w, __fmul_rn(w, vx), __fmul_rn(w, vy), __fmul_rn(w, vz));
  *w_mask = w != 0.0f ? mask : 0ull;
}

// The backward's round scratch: per compacted voxel (w, w v); after the
// last round, the (segment, k) sums and the frame's final sums.
union BwdScratch {
  float4 w4[CHUNK];
  float4 red[THREADS];
};

// partial: (M, n_tiles, K, 4) float32, (S_k, P_k.x, P_k.y, P_k.z) of the
// tile's voxels; tickets as for the forward; dkp: (M, K, 3) float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    chamfer_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ kp, const T* __restrict__ occ,
                       const float* __restrict__ lin, float* partial,
                       unsigned int* tickets, float* __restrict__ dkp, int K,
                       int G, int n_tiles) {
  __shared__ unsigned int s_idx[TILE_VOXELS];
  __shared__ float s_val[TILE_VOXELS];
  __shared__ float4 s_kp[MAX_K];
  __shared__ unsigned long long s_scan[WARPS];
  __shared__ unsigned long long s_mask[CHUNK];
  __shared__ BwdScratch s_u;
  __shared__ int s_last;
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  const unsigned int G3 = (unsigned int)G * G * G;
  const int n = compact_tile(occ + (int64_t)m * G3, G3, tile * TILE_VOXELS,
                             kp, m, K, s_kp, s_idx, s_val, s_scan);
  const float gm = g[m];
  // thread (k, seg) = (threadIdx.x % K, threadIdx.x / K) while seg < nseg
  const int nseg = THREADS / K;
  const int k = threadIdx.x % K, seg = threadIdx.x / K;
  float S = 0.0f, Px = 0.0f, Py = 0.0f, Pz = 0.0f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int cn = min(CHUNK, n - c0);
    // weigh the round's voxels, two per pass over the keypoints
    for (int j = threadIdx.x; j < cn; j += 2 * THREADS) {
      const int j1 = j + THREADS;
      const bool two = j1 < cn;
      float ax, ay, az, bx, by, bz;
      voxel_coords(lin, s_idx[c0 + j], G, &ax, &ay, &az);
      voxel_coords(lin, s_idx[c0 + (two ? j1 : j)], G, &bx, &by, &bz);
      float best_a = __int_as_float(0x7f800000), best_b = best_a;  // +inf
      unsigned long long mask_a = 0, mask_b = 0, bit = 1;
      for (int kk = 0; kk < K; ++kk, bit <<= 1) {
        const float4 c = s_kp[kk];
        tie_step(chamfer_val(c, ax, ay, az), bit, &best_a, &mask_a);
        tie_step(chamfer_val(c, bx, by, bz), bit, &best_b, &mask_b);
      }
      weigh(ax, ay, az, best_a, mask_a, gm, s_val[c0 + j], &s_u.w4[j],
            &s_mask[j]);
      if (two)
        weigh(bx, by, bz, best_b, mask_b, gm, s_val[c0 + j1], &s_u.w4[j1],
              &s_mask[j1]);
    }
    __syncthreads();
    // thread (k, seg): its segment's voxels whose mask has bit k, in order
    if (seg < nseg) {
      const int hi = (seg + 1) * cn / nseg;
      for (int j = seg * cn / nseg; j < hi; ++j) {
        if (s_mask[j] >> k & 1ull) {
          const float4 t = s_u.w4[j];
          S += t.x;
          Px += t.y;
          Py += t.z;
          Pz += t.w;
        }
      }
    }
    __syncthreads();
  }
  if (seg < nseg) s_u.red[threadIdx.x] = make_float4(S, Px, Py, Pz);
  __syncthreads();
  float4* pm = reinterpret_cast<float4*>(partial) + (int64_t)m * n_tiles * K;
  if (threadIdx.x < K) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < nseg; ++s) {
      const float4 b = s_u.red[s * K + threadIdx.x];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    pm[(int64_t)tile * K + threadIdx.x] = a;
  }
  if (!last_of_frame(tickets + m, n_tiles, &s_last)) return;

  // the frame's sums: thread (i, q), i one of the 4 K floats of a tile's
  // partial, sums tiles q, q + Q, ... in order; then the Q groups in order
  const int nout = 4 * K, Q = THREADS / nout;
  const int i = threadIdx.x % nout, q = threadIdx.x / nout;
  const float* pf = reinterpret_cast<const float*>(pm);
  float* s_fin = reinterpret_cast<float*>(s_u.red);  // Q nout <= THREADS
  float* s_sum = s_fin + THREADS;                     // nout <= THREADS
  if (q < Q) {
    float a = 0.0f;
#pragma unroll 16
    for (int t = q; t < n_tiles; t += Q) a += __ldcg(pf + (int64_t)t * nout + i);
    s_fin[q * nout + i] = a;
  }
  __syncthreads();
  if (threadIdx.x < nout) {
    float a = 0.0f;
    for (int qq = 0; qq < Q; ++qq) a += s_fin[qq * nout + threadIdx.x];
    s_sum[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < 3 * K) {
    const int kk = threadIdx.x / 3, ax = threadIdx.x % 3;
    const float c = kp[(int64_t)m * K * 3 + threadIdx.x];
    dkp[(int64_t)m * K * 3 + threadIdx.x] = __fsub_rn(
        __fmul_rn(2.0f * c, s_sum[kk * 4]), 2.0f * s_sum[kk * 4 + 1 + ax]);
  }
  if (threadIdx.x == 0) tickets[m] = 0;
}

// docc[m, v] = g[m] relu(dmin(v)) at every voxel, VEC voxels per thread,
// written with one 16-byte store where aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    chamfer_docc_kernel(const float* __restrict__ g,
                        const float* __restrict__ kp,
                        const float* __restrict__ lin, T* __restrict__ docc,
                        int K, int G) {
  constexpr int VEC = Occ<T>::VEC;
  __shared__ float4 s_kp[MAX_K];
  const int m = blockIdx.y;
  stage_keypoints(kp, m, K, s_kp);
  __syncthreads();
  const unsigned int G3 = (unsigned int)G * G * G;
  const unsigned int v0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (v0 >= G3) return;
  const float gm = g[m];
  T* row = docc + (int64_t)m * G3;
  float out[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out[e] = 0.0f;
    if (v0 + e < G3) {
      float vx, vy, vz;
      voxel_coords(lin, v0 + e, G, &vx, &vy, &vz);
      const float dmin =
          __fadd_rn(sq3(vx, vy, vz), min_val(s_kp, K, vx, vy, vz));
      out[e] = gm * fmaxf(dmin, 0.0f);
    }
  }
  if (v0 + VEC <= G3 && aligned16(row + v0)) {
    *reinterpret_cast<uint4*>(row + v0) = Occ<T>::pack(out);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (v0 + e < G3) Occ<T>::store(row + v0 + e, out[e]);
  }
}

// The launch geometry the wrapper must have sized its buffers with.
static bool bad_shape(int M, int K, int G, int n_tiles) {
  if (K < 1 || K > MAX_K || G < 1 || M > 65535) return true;
  const long long G3 = (long long)G * G * G;
  return G3 >= (1ll << 31) ||
         n_tiles != (int)((G3 + TILE_VOXELS - 1) / TILE_VOXELS);
}

extern "C" {

// Voxels per block; the wrapper sizes the partial buffers with it.
int nm_chamfer_tile_voxels() { return TILE_VOXELS; }

int nm_chamfer_max_k() { return MAX_K; }

// kp: (M, K, 3) float32; occ: (M, G^3) float32 (occ_bf16 == 0) or
// bfloat16 (occ_bf16 == 1); lin: (G,) float32 linspace(-1, 1, G);
// partial: (M, n_tiles) float32 scratch, n_tiles = ceil(G^3 /
// TILE_VOXELS); tickets: (M,) int32, zero, left zero; num: (M,) float32
// output. Returns cudaGetLastError() after the launch.
int nm_chamfer_fwd(const void* kp, const void* occ, int occ_bf16,
                   const void* lin, void* partial, void* tickets, void* num,
                   int M, int K, int G, int n_tiles, int device,
                   void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (M == 0) return (int)cudaSuccess;
  if (bad_shape(M, K, G, n_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned int)n_tiles, (unsigned int)M);
  if (occ_bf16) {
    chamfer_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const float*)kp, (const __nv_bfloat16*)occ, (const float*)lin,
        (float*)partial, (unsigned int*)tickets, (float*)num, K, G, n_tiles);
  } else {
    chamfer_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)kp, (const float*)occ, (const float*)lin,
        (float*)partial, (unsigned int*)tickets, (float*)num, K, G, n_tiles);
  }
  return (int)cudaGetLastError();
}

// g: (M,) float32 upstream gradient; kp, occ, occ_bf16, lin, tickets as for
// the forward; partial: (M, n_tiles, K, 4) float32 scratch; dkp: (M, K, 3)
// float32 output; docc: (M, G^3) in the occupancy's type, or null when the
// occupancy needs no gradient. Returns cudaGetLastError() after the
// launches.
int nm_chamfer_bwd(const void* g, const void* kp, const void* occ,
                   int occ_bf16, const void* lin, void* partial,
                   void* tickets, void* dkp, void* docc, int M, int K, int G,
                   int n_tiles, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (M == 0) return (int)cudaSuccess;
  if (bad_shape(M, K, G, n_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned int)n_tiles, (unsigned int)M);
  const float* gf = (const float*)g;
  const float* kpf = (const float*)kp;
  const float* linf = (const float*)lin;
  float* pf = (float*)partial;
  unsigned int* tk = (unsigned int*)tickets;
  const long long G3 = (long long)G * G * G;
  if (occ_bf16) {
    chamfer_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        gf, kpf, (const __nv_bfloat16*)occ, linf, pf, tk, (float*)dkp, K, G,
        n_tiles);
  } else {
    chamfer_bwd_kernel<float><<<grid, THREADS, 0, s>>>(
        gf, kpf, (const float*)occ, linf, pf, tk, (float*)dkp, K, G, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !docc) return (int)err;
  const long long per_block = (long long)THREADS * (occ_bf16 ? 8 : 4);
  dim3 dgrid((unsigned int)((G3 + per_block - 1) / per_block),
             (unsigned int)M);
  if (occ_bf16) {
    chamfer_docc_kernel<__nv_bfloat16><<<dgrid, THREADS, 0, s>>>(
        gf, kpf, linf, (__nv_bfloat16*)docc, K, G);
  } else {
    chamfer_docc_kernel<float><<<dgrid, THREADS, 0, s>>>(
        gf, kpf, linf, (float*)docc, K, G);
  }
  return (int)cudaGetLastError();
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
