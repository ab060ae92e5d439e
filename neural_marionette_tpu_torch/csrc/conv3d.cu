// SAME-padded odd cubic 3D convolution plus bias (kernel K3 of the port),
// and the same convolution with per-channel moment partials (pass 1 of
// kernel K4, the fused conv + GroupNorm + LeakyReLU stage).
//
// Replaces: neural_marionette_tpu/ops/pallas/conv3d_kernel.py,
//   _conv3d_pallas_fwd / _conv_kernel (K3), and
//   neural_marionette_tpu/ops/pallas/fusedstage_kernel.py,
//   fused_stage / _conv_stats_kernel (K4 pass 1).
//
// Semantics (those of _conv3d_pallas_fwd): x and w rounded to bf16, the
// products summed in f32, b rounded to bf16 and added in f32, one rounding
// to x's dtype (float32 or bfloat16). Zero padding of k/2 on every face.
// With stats, the block also writes, per (frame, voxel tile, channel), the
// f32 sum and sum of squares of its outputs BEFORE that rounding
// (fusedstage_kernel.py:104-111); the wrapper sums the tiles in a fixed
// order, so no float atomics are used and two launches give equal bits.
//
// Layout: x and y are addressed through element strides of the logical
// (F, D, H, W, C) view, so the port's NCDHW activations are read and
// written in place (no layout copy) and a channels-last tensor works too.
// w is packed by the wrapper as (k^3, cin_pad, cout_pad) bf16, zero-padded.
//
// Bound on the H100: operations. A routed conv does 2 F D H W k^3 Cin Cout
// flops over one read of x and one write of y; at the decoder's 40 x 64^3,
// 64 -> 32 that is 1.16e12 flops (1.17 ms at 989 TFLOP/s dense bf16)
// against 2.0 GB (0.60 ms at 3.35 TB/s).
// Design, simple first: an implicit GEMM. M = the output voxels of one
// frame (tiles of BM = 128, one block row per thread), N = Cout (tiles of
// 32 or 64), K = k^3 taps x Cin (chunks of BK = 32 channels of one tap).
// Each K step gathers the tile's input voxels for one tap with masked
// halo loads (no padded copy of x), converts to bf16 and stages A and B in
// shared memory; four warps run bf16 tensor-core MMAs (nvcuda::wmma
// 16x16x16, f32 accumulators). The next step's global loads are issued
// into registers before the current step's MMAs. The epilogue stages the
// accumulators in shared memory, adds the bias and writes one output
// voxel per thread, so each warp writes 32 neighbouring voxels of one
// channel. Not done yet (later work): TMA, wgmma, a multi-stage smem
// pipeline, and reuse of the input halo across taps; every tap re-reads
// its voxels (from L1/L2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output voxels per block (one frame)
constexpr int BK = 32;        // input channels per K step (one tap)
constexpr int THREADS = 128;  // four warps; thread t owns tile row t
constexpr int A_LD = BK + 8;  // smem row pitch of A in bf16 (80 bytes)

struct Geometry {
  int D, H, W, Cin, Cout, k, cin_pad, cout_pad;
  long long xs[5];  // x strides (elements) of the logical (F, D, H, W, C)
  long long ys[5];  // y strides, likewise
};

__device__ __forceinline__ unsigned short bf16_bits(const float* p,
                                                    long long off) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(p + off)));
}
__device__ __forceinline__ unsigned short bf16_bits(const __nv_bfloat16* p,
                                                    long long off) {
  return __ldg(reinterpret_cast<const unsigned short*>(p) + off);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BN, int WARPS_M, bool STATS>
__global__ void __launch_bounds__(THREADS)
conv3d_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              const __nv_bfloat16* __restrict__ bias, T* __restrict__ y,
              float* __restrict__ stats, Geometry g) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int B_LD = BN + 8;   // smem row pitch of B in bf16
  constexpr int C_LD = BM + 4;   // column-major f32 staging: (m, n) at n*C_LD+m
  constexpr int B_VEC = BK * BN / 8;                // uint4 per B tile
  constexpr int B_PER = (B_VEC + THREADS - 1) / THREADS;
  constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * 2;
  constexpr int C_BYTES = BN * C_LD * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float red[2][THREADS];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * A_LD;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int f = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = g.H * g.W;
  const int DHW = g.D * HW;
  const int pad = g.k / 2;

  // this thread's output voxel: row tid of the tile
  const int m = m0 + tid;
  const bool m_ok = m < DHW;
  int oz = 0, oy = 0, ox = 0;
  if (m_ok) {
    oz = m / HW;
    const int r = m - oz * HW;
    oy = r / g.W;
    ox = r - oy * g.W;
  }
  const T* xf = x + (long long)f * g.xs[0];

  const int kchunks = g.cin_pad / BK;
  const int iters = g.k * g.k * g.k * kchunks;

  uint32_t a_reg[BK / 2];
  uint4 b_reg[B_PER];

  auto load = [&](int it) {
    const int tap = it / kchunks;
    const int c0 = (it - tap * kchunks) * BK;
    const int dz = tap / (g.k * g.k), dy = (tap / g.k) % g.k, dx = tap % g.k;
    const int iz = oz + dz - pad, iy = oy + dy - pad, ix = ox + dx - pad;
    const bool ok = m_ok && iz >= 0 && iz < g.D && iy >= 0 && iy < g.H &&
                    ix >= 0 && ix < g.W;
    if (ok) {
      const long long base = iz * g.xs[1] + iy * g.xs[2] + ix * g.xs[3] +
                             c0 * g.xs[4];
      const long long cs = g.xs[4];
      if (c0 + BK <= g.Cin) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const uint32_t lo = bf16_bits(xf, base + (2 * j) * cs);
          const uint32_t hi = bf16_bits(xf, base + (2 * j + 1) * cs);
          a_reg[j] = lo | (hi << 16);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int c = c0 + 2 * j;
          const uint32_t lo = c < g.Cin ? bf16_bits(xf, base + (2 * j) * cs)
                                        : 0u;
          const uint32_t hi =
              c + 1 < g.Cin ? bf16_bits(xf, base + (2 * j + 1) * cs) : 0u;
          a_reg[j] = lo | (hi << 16);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) a_reg[j] = 0u;
    }
    const __nv_bfloat16* wt =
        w + ((long long)tap * g.cin_pad + c0) * g.cout_pad + n0;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < B_VEC) {
        const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
        b_reg[i] = __ldg(reinterpret_cast<const uint4*>(
            wt + (long long)row * g.cout_pad + col));
      }
    }
  };

  auto store = [&]() {
    uint4* dst = reinterpret_cast<uint4*>(As + tid * A_LD);
#pragma unroll
    for (int q = 0; q < BK / 8; ++q)
      dst[q] = make_uint4(a_reg[4 * q], a_reg[4 * q + 1], a_reg[4 * q + 2],
                          a_reg[4 * q + 3]);
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < B_VEC) {
        const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + row * B_LD + col) = b_reg[i];
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  store();
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const bool more = it + 1 < iters;
    if (more) load(it + 1);  // in flight during this step's MMAs
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * A_LD + kk * 16,
                               A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * 16 * B_LD + wn * WN + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue: accumulators -> smem (column-major), + bias, one rounding
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wn * WN + j * 16) * C_LD + wm * WM + i * 16,
                              acc[i][j], C_LD, wmma::mem_col_major);
  __syncthreads();
  const int n_valid = min(BN, g.Cout - n0);
  if (m_ok) {
    T* yp = y + (long long)f * g.ys[0] + oz * g.ys[1] + oy * g.ys[2] +
            ox * g.ys[3];
    for (int n = 0; n < n_valid; ++n)
      store_out(yp + (long long)(n0 + n) * g.ys[4],
                Cs[n * C_LD + tid] + __bfloat162float(bias[n0 + n]));
  }
  if (STATS) {
    // per channel of the tile: sum and sum of squares of the f32 outputs
    // over the tile's valid voxels; THREADS / BN threads per channel, each
    // over a fixed run of rows, then summed in thread order
    constexpr int PARTS = THREADS / BN;
    constexpr int ROWS = BM / PARTS;
    const int n = tid % BN, part = tid / BN;
    float s = 0.0f, q = 0.0f;
    if (n < n_valid) {
      const float bn = __bfloat162float(bias[n0 + n]);
      const int r_end = min(ROWS * (part + 1), DHW - m0);
      for (int r = ROWS * part; r < r_end; ++r) {
        const float v = Cs[n * C_LD + r] + bn;
        s += v;
        q = fmaf(v, v, q);
      }
    }
    red[0][tid] = s;
    red[1][tid] = q;
    __syncthreads();
    if (tid < n_valid) {
      float S = 0.0f, Q = 0.0f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        S += red[0][p * BN + tid];
        Q += red[1][p * BN + tid];
      }
      // stats: (F, tiles, 2, Cout) float32
      float* sp = stats + ((long long)f * gridDim.x + blockIdx.x) * 2 * g.Cout;
      sp[n0 + tid] = S;
      sp[g.Cout + n0 + tid] = Q;
    }
  }
}

template <typename T, int BN, bool STATS>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   void* stats, int F, const Geometry& g, cudaStream_t s) {
  constexpr int WARPS_M = BN == 64 ? 2 : 4;
  const int DHW = g.D * g.H * g.W;
  dim3 grid((DHW + BM - 1) / BM, g.cout_pad / BN, F);
  conv3d_kernel<T, BN, WARPS_M, STATS><<<grid, THREADS, 0, s>>>(
      (const T*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias, (T*)y,
      (float*)stats, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bn, bool with_stats, const void* x, const void* w,
                     const void* bias, void* y, void* stats, int F,
                     const Geometry& g, cudaStream_t s) {
  if (bn == 64)
    return with_stats ? launch<T, 64, true>(x, w, bias, y, stats, F, g, s)
                      : launch<T, 64, false>(x, w, bias, y, stats, F, g, s);
  return with_stats ? launch<T, 32, true>(x, w, bias, y, stats, F, g, s)
                    : launch<T, 32, false>(x, w, bias, y, stats, F, g, s);
}

}  // namespace

extern "C" {

// Voxel tile (rows of M) and channel chunk (rows of K per tap) of the
// kernel: the wrapper sizes the stats buffer and the packed weight by them.
int nm_conv3d_tile_m() { return BM; }
int nm_conv3d_tile_k() { return BK; }

// x: logical (F, D, H, W, Cin), float32 (x_bf16 == 0) or bfloat16, element
// strides xs0..xs4. w: (k^3, cin_pad, cout_pad) bfloat16, contiguous, zero
// beyond (Cin, Cout); cin_pad a multiple of the channel chunk, cout_pad of
// bn (32 or 64). bias: (Cout,) bfloat16, contiguous. y:
// logical (F, D, H, W, Cout) in x's dtype, strides ys0..ys4. stats: NULL,
// or (F, ceil(D H W / tile_m), 2, Cout) float32, every entry written.
// Returns cudaGetLastError() after the launch.
int nm_conv3d(const void* x, int x_bf16, const void* w, const void* bias,
              void* y, void* stats, int F, int D, int H, int W, int Cin,
              int Cout, int k, long long xs0, long long xs1, long long xs2,
              long long xs3, long long xs4, long long ys0, long long ys1,
              long long ys2, long long ys3, long long ys4, int cin_pad,
              int cout_pad, int bn, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if ((bn != 32 && bn != 64) || k < 1 || k % 2 == 0 || cin_pad % BK ||
      cin_pad < Cin || cout_pad % bn || cout_pad < Cout || F > 65535)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || D == 0 || H == 0 || W == 0 || Cout == 0)
    return (int)cudaSuccess;
  Geometry g{D, H, W, Cin, Cout, k, cin_pad, cout_pad,
             {xs0, xs1, xs2, xs3, xs4}, {ys0, ys1, ys2, ys3, ys4}};
  cudaStream_t s = (cudaStream_t)stream;
  const bool with_stats = stats != nullptr;
  cudaError_t err =
      x_bf16 ? dispatch<__nv_bfloat16>(bn, with_stats, x, w, bias, y, stats,
                                       F, g, s)
             : dispatch<float>(bn, with_stats, x, w, bias, y, stats, F, g, s);
  return (int)err;
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
