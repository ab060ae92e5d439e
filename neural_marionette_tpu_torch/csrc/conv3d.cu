// SAME-padded odd cubic 3D convolution plus bias (kernel K3 of the port),
// and the same convolution with per-channel moment partials (pass 1 of
// kernel K4, the fused conv + GroupNorm + LeakyReLU stage).
//
// Replaces: neural_marionette_tpu/ops/pallas/conv3d_kernel.py,
//   _conv3d_pallas_fwd / _conv_kernel (K3), and
//   neural_marionette_tpu/ops/pallas/fusedstage_kernel.py,
//   fused_stage / _conv_stats_kernel (K4 pass 1).
//
// Semantics (those of _conv3d_pallas_fwd): x and w in bf16 (the wrapper
// rounds a float32 x to bf16 to nearest before the launch), the products
// summed in f32, b in bf16 added in f32, one rounding to y's dtype (float32
// or bfloat16). Zero padding of k/2 on every face. With stats, the block
// also writes, per (frame, brick, channel), the f32 sum and sum of squares
// of its outputs BEFORE that rounding (fusedstage_kernel.py:104-111); the
// wrapper sums the bricks in a fixed order, so no float atomics are used
// and two launches give equal bits (the accumulation order is fixed too:
// no split-K).
//
// Layout: x and y are addressed through element strides of the logical
// (F, D, H, W, C) view, so the port's NCDHW activations are read and
// written in place (no layout copy) and a channels-last tensor works too.
// w is packed once per parameter version by the wrapper
// (ops/conv3d.pack_weight) as (Cout tiles, k^3, cin_pad / 8, NT, 8) bf16,
// zero-padded: each (tile, tap, channel chunk) is one contiguous block in
// the layout the tensor cores read.
//
// Bound on the H100: operations. A routed conv does 2 F D H W k^3 Cin Cout
// flops over one read of x and one write of y; at the decoder's 40 x 64^3,
// 64 -> 32 that is 1.16e12 flops (1.17 ms at 989 TFLOP/s dense bf16)
// against 2.0 GB (0.60 ms at 3.35 TB/s).
//
// Design, for Hopper (sm_90a): an implicit GEMM on warpgroup MMAs. One
// block (one warpgroup, 128 threads) computes a brick of ZT x 8 x BX
// output voxels of one frame for a tile of NT output channels (NT = 32, 64
// or 128; ZT x BX = 4 x 16, 4 x 8 or 2 x 8: 128 f32 accumulators a
// thread); each 8 x 8 (y, x) block of the brick is one 64-row
// `wgmma.mma_async` m64nNTk16 tile (bf16 in, f32 accumulators in
// registers). K runs over chunks of 32 input channels and the k^3 taps:
// * per chunk, the block stages its brick plus a k/2 halo, (ZT+k-1) x
//   (8+k-1) x (BX+k-1) voxels x 32 channels, in shared memory ONCE for all
//   k^3 taps, voxel-major with 8 channels (16 bytes) innermost, the
//   out-of-grid voxels written as zeros (the SAME padding, so no padded
//   copy of x). NCDHW runs along x are read with 16-byte loads (8 channels
//   x 8 voxels per thread) and transposed in registers; the halo columns,
//   grids with W % 8 != 0 (2^3, 4^3) and other layouts gather 8 channels of
//   one voxel per thread (a shape-based choice inside this kernel, never a
//   fallback on failure). The gather's memory requests (about three per
//   halo row and channel), not its bytes, bound the 32-column tile, whose
//   MMAs are short: its brick is 16 wide, and two neighbouring lanes read
//   the halves of one 32-byte sector, one request for 16 voxels. At NT = 64
//   the deeper 8-wide brick measured faster;
// * every tap's A operand is then the same brick at a constant offset: the
//   wgmma shared-memory descriptor (no swizzle; 8 rows of 16 bytes per core
//   matrix = 8 neighbouring voxels along x, rows of the brick BX + k - 1
//   voxels apart) starts at ((dz (8+k-1) + dy) (BX+k-1) + dx) voxels, any
//   16-byte address being legal. The 27x re-read of the input is gone;
// * B, the packed weight of (tap, chunk), streams through a ring of five
//   shared-memory stages with cp.async three taps ahead, while the tensor
//   cores run the current tap and one group of MMAs stays in flight.
// A Cout of 256 takes two N tiles (two blocks read the same brick); a
// ragged Cin pads the last chunk with zeros. The epilogue stages the f32
// accumulators (+ bias) in shared memory, then writes NCDHW runs of 8
// voxels along x as 16-byte stores (masked scalar stores where W % 8 != 0
// or y is not x-contiguous) and, with stats, the moment partials.
// Not done yet (later work): the halo gather is synchronous, so within a
// block it does not overlap the MMAs (two or three blocks per SM overlap
// each other). Streaming the next chunk's halo with per-thread cp.async
// into a staging area, transposed between chunks, was tried and was slower
// (PERF.md): it issues the same requests, from fewer threads.
// The route to the bound is fewer requests per voxel: TMA boxes of the
// NCDHW input on an mbarrier, from a warp-specialised producer, and a
// persistent grid.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // one warpgroup
constexpr int CK = 32;        // input channels per K chunk
constexpr int BY = 8;         // brick rows; a 64-row tile is 8 rows x 8 columns
constexpr int B_STAGES = 5;   // ring of weight tiles
constexpr int B_AHEAD = B_STAGES - 2;  // loads run this many taps ahead
constexpr int MAX_K = 7;
constexpr int SMEM_LIMIT = 227 * 1024;

// brick depth ZT and width 8 XT for an N tile: ZT XT tiles of 64 rows,
// ZT XT NT / 2 = 128 accumulators a thread
template <int NT>
struct Tile;
template <>
struct Tile<32> { static constexpr int ZT = 4, XT = 2; };
template <>
struct Tile<64> { static constexpr int ZT = 4, XT = 1; };
template <>
struct Tile<128> { static constexpr int ZT = 2, XT = 1; };

struct Geometry {
  int D, H, W, Cin, Cout, k, cin_pad;
  int nbx, nby;            // bricks along x (set per tile width) and y
  int fast_in, fast_out;   // 16-byte x-runs of x / of y
  long long xs[5];         // x strides (elements) of the logical (F, D, H, W, C)
  long long ys[5];         // y strides, likewise
};

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16, A and B from shared memory
// through descriptors, both K-major; accumulates into d.
template <int NT>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, no swizzle: 8 rows of 16 bytes per core
// matrix; lbo = bytes between the two 8-element K halves, sbo = bytes
// between groups of 8 rows (M or N).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory -> visible to the tensor cores
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads across the async MMAs
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low, b high
  return *reinterpret_cast<uint32_t*>(&h);
}
// 8 neighbouring f32 values (16-byte aligned in shared memory) -> one run
__device__ __forceinline__ void store8(float* p, const float* s) {
  reinterpret_cast<float4*>(p)[0] = reinterpret_cast<const float4*>(s)[0];
  reinterpret_cast<float4*>(p)[1] = reinterpret_cast<const float4*>(s)[1];
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* s) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w),
                                            pack2(b.x, b.y), pack2(b.z, b.w));
}

template <int NT>
constexpr int epilogue_bytes() {
  return NT * (Tile<NT>::ZT * Tile<NT>::XT * 64 + 4) * 4;
}

// NT = 64 and 128 fit three blocks on an SM (168 registers a thread); the
// 32-column tile's larger brick (79 KB of shared memory) keeps two
template <typename TO, int NT, bool STATS>
__global__ void __launch_bounds__(THREADS, NT == 32 ? 2 : 3)
conv3d_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ wpk,
              const __nv_bfloat16* __restrict__ bias, TO* __restrict__ y,
              float* __restrict__ stats, Geometry g) {
  constexpr int ZT = Tile<NT>::ZT, XT = Tile<NT>::XT;
  constexpr int BX = 8 * XT;          // brick columns
  constexpr int MT = ZT * XT;         // 64-row tiles: tile z XT + x half
  constexpr int ROWS = MT * 64;       // output voxels of a brick
  constexpr int ACC = NT / 2;         // accumulators a thread, per z plane
  constexpr int LDC = ROWS + 4;       // epilogue staging pitch (floats)
  constexpr int CG = CK / 8;          // 16-byte channel groups per chunk
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int k = g.k, pad = k / 2;
  const int HX = BX + k - 1;       // halo columns
  const int HY = BY + k - 1;       // halo rows
  const int ZB = ZT + k - 1;       // halo planes
  const int NV = ZB * HY * HX;     // halo voxels
  // A: brick + halo of one chunk, [CG][NV][8 channels] bf16
  uint4* As = reinterpret_cast<uint4*>(smem);
  // B: ring of weight tiles, each [CG][NT][8 channels] bf16
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(As + (size_t)CG * NV);
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue: [NT][LDC]

  const int f = blockIdx.z, ntile = blockIdx.y;
  const int bx = blockIdx.x % g.nbx, rest = blockIdx.x / g.nbx;
  const int by = rest % g.nby, bz = rest / g.nby;
  const int x0 = bx * BX, y0 = by * BY, z0 = bz * ZT;
  const int taps = k * k * k;
  const int nchunks = g.cin_pad / CK;
  const int steps = nchunks * taps;
  const int cg_total = g.cin_pad / 8;
  const __nv_bfloat16* xf = x + (long long)f * g.xs[0];
  const __nv_bfloat16* wt = wpk + (long long)ntile * taps * cg_total * NT * 8;

  // B of step s = (chunk c, tap t) into ring slot s % B_STAGES; an empty
  // group past the last step keeps the group count uniform
  auto load_b = [&](int s) {
    if (s < steps) {
      const int c = s / taps, t = s - c * taps;
      const __nv_bfloat16* src =
          wt + ((long long)t * cg_total + c * CG) * NT * 8;
      __nv_bfloat16* dst = Bs + (s % B_STAGES) * (CK * NT);
      for (int i = tid; i < CK * NT / 8; i += THREADS)
        cp_async16(dst + i * 8, src + i * 8);
    }
    cp_async_commit();
  };

  // 8 channels (group cg of chunk c0) of halo voxel (hz, hy, hx) -> A;
  // zeros outside the grid and past Cin
  auto gather_voxel = [&](int cg, int hz, int hy, int hx, int c0) {
    const int iz = z0 - pad + hz, iy = y0 - pad + hy, ix = x0 - pad + hx;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (iz >= 0 && iz < g.D && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(xf) +
                                iz * g.xs[1] + iy * g.xs[2] + ix * g.xs[3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + cg * 8 + 2 * j;
        const uint32_t lo = ch < g.Cin ? __ldg(p + ch * g.xs[4]) : 0u;
        const uint32_t hi = ch + 1 < g.Cin ? __ldg(p + (ch + 1) * g.xs[4]) : 0u;
        v[j] = lo | (hi << 16);
      }
    }
    As[(size_t)cg * NV + (hz * HY + hy) * HX + hx] =
        make_uint4(v[0], v[1], v[2], v[3]);
  };

  auto load_halo = [&](int c) {
    const int c0 = c * CK;
    if (g.fast_in) {
      // the brick's x-runs of each halo row: 8 channels x 8 voxels, 16-byte
      // loads along x (the halves of a 16-voxel run in neighbouring lanes),
      // transposed in registers to 8 voxels x 8 channels; the same thread
      // gathers the row's halo columns on its side while they land
      const int runs = ZB * HY * CG * XT;
      for (int u = tid; u < runs; u += THREADS) {
        const int half = u % XT, cg = (u / XT) % CG, r = u / (XT * CG);
        const int hy = r % HY, hz = r / HY;
        const int iz = z0 - pad + hz, iy = y0 - pad + hy;
        const int ix = x0 + 8 * half;
        const bool ok = iz >= 0 && iz < g.D && iy >= 0 && iy < g.H && ix < g.W;
        uint32_t v[8][4];
#pragma unroll
        for (int ci = 0; ci < 8; ++ci) {
          const int ch = c0 + cg * 8 + ci;
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (ok && ch < g.Cin)
            q = __ldg(reinterpret_cast<const uint4*>(
                xf + ch * g.xs[4] + iz * g.xs[1] + iy * g.xs[2] + ix));
          v[ci][0] = q.x;
          v[ci][1] = q.y;
          v[ci][2] = q.z;
          v[ci][3] = q.w;
        }
        if (half == 0)
          for (int e = 0; e < pad; ++e) gather_voxel(cg, hz, hy, e, c0);
        if (half == XT - 1)
          for (int e = pad + BX; e < HX; ++e) gather_voxel(cg, hz, hy, e, c0);
        uint4* dst =
            As + (size_t)cg * NV + (hz * HY + hy) * HX + pad + 8 * half;
#pragma unroll
        for (int xi = 0; xi < 8; ++xi) {
          const uint32_t sel = (xi & 1) ? 0x7632u : 0x5410u;
          const int w = xi / 2;
          dst[xi] = make_uint4(__byte_perm(v[0][w], v[1][w], sel),
                               __byte_perm(v[2][w], v[3][w], sel),
                               __byte_perm(v[4][w], v[5][w], sel),
                               __byte_perm(v[6][w], v[7][w], sel));
        }
      }
    } else {
      const int items = NV * CG;
      for (int u = tid; u < items; u += THREADS) {
        const int cg = u % CG, v = u / CG;
        gather_voxel(cg, v / (HY * HX), (v / HX) % HY, v % HX, c0);
      }
    }
  };

  float acc[MT][ACC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[m][i] = 0.0f;

  const uint32_t a_base = smem_u32(As), b_base = smem_u32(Bs);
  const uint32_t a_lbo = NV * 16, a_sbo = HX * 16, a_plane = HY * HX * 16;
  constexpr uint32_t b_lbo = NT * 16, b_sbo = 8 * 16;

  for (int s = 0; s < B_AHEAD; ++s) load_b(s);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every warp has waited for the last chunk's MMAs
    load_halo(c);
    fence_async_smem();
    for (int t = 0; t < taps; ++t) {
      const int s = c * taps + t;
      cp_async_wait<B_AHEAD - 1>();  // this step's weight tile has landed
      fence_async_smem();
      __syncthreads();     // ... for every thread; A is complete
      load_b(s + B_AHEAD); // the slot of step s - 2, whose MMAs are done
      const int dz = t / (k * k), dy = (t / k) % k, dx = t % k;
      const uint32_t a_tap = a_base + ((dz * HY + dy) * HX + dx) * 16;
      const uint32_t b_step = b_base + (s % B_STAGES) * (CK * NT * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk)
          Wgmma<NT>::mma(acc[m],
                         make_desc(a_tap + (m / XT) * a_plane +
                                       (m % XT) * 8 * 16 + 2 * kk * a_lbo,
                                   a_lbo, a_sbo),
                         make_desc(b_step + 2 * kk * b_lbo, b_lbo, b_sbo));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's MMAs are done
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
  }
  cp_async_wait<0>();
  __syncthreads();  // A and B are free: the epilogue stages over them

  // accumulators + bias -> Cs[n][tile * 64 + row]; the wgmma layout:
  // warp w holds rows 16w..16w+15, lane l rows l/4 and l/4 + 8 and columns
  // 2 (l % 4) + {0, 1} of every 8-column slice
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = ntile * NT;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int row = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
    const float bn = n0 + col < g.Cout ? __bfloat162float(bias[n0 + col]) : 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) Cs[col * LDC + m * 64 + row] = acc[m][i] + bn;
  }
  __syncthreads();

  const long long yf = (long long)f * g.ys[0];
  if (g.fast_out) {
    // one run of 8 voxels along x of one channel per item, a 16-byte store
    for (int u = tid; u < NT * MT * BY; u += THREADS) {
      const int yy = u % BY, r = u / BY;
      const int m = r % MT, n = r / MT;
      const int oz = z0 + m / XT, oy = y0 + yy, ox = x0 + 8 * (m % XT);
      const int ch = n0 + n;
      if (ch < g.Cout && oz < g.D && oy < g.H && ox < g.W)
        store8(y + yf + ch * g.ys[4] + oz * g.ys[1] + oy * g.ys[2] + ox,
               Cs + n * LDC + m * 64 + yy * 8);
    }
  } else {
    for (int u = tid; u < NT * ROWS; u += THREADS) {
      const int m = u % ROWS, n = u / ROWS;
      const int oz = z0 + m / 64 / XT, oy = y0 + (m / 8) % 8;
      const int ox = x0 + 8 * ((m / 64) % XT) + m % 8;
      const int ch = n0 + n;
      if (ch < g.Cout && oz < g.D && oy < g.H && ox < g.W)
        store_out(y + yf + ch * g.ys[4] + oz * g.ys[1] + oy * g.ys[2] +
                      ox * g.ys[3],
                  Cs[n * LDC + m]);
    }
  }
  if (STATS) {
    // per channel: sum and sum of squares of the f32 outputs over the
    // brick's voxels in the grid; THREADS / NT threads per channel, each
    // over a fixed run of rows, then summed in thread order
    __shared__ float red[2][THREADS];
    constexpr int PARTS = THREADS / NT;
    constexpr int PER = ROWS / PARTS;
    const int n = tid % NT, part = tid / NT;
    float s = 0.0f, q = 0.0f;
    if (n0 + n < g.Cout) {
      for (int m = part * PER; m < (part + 1) * PER; ++m) {
        if (z0 + m / 64 / XT < g.D && y0 + (m / 8) % 8 < g.H &&
            x0 + 8 * ((m / 64) % XT) + m % 8 < g.W) {
          const float v = Cs[n * LDC + m];
          s += v;
          q = fmaf(v, v, q);
        }
      }
    }
    red[0][tid] = s;
    red[1][tid] = q;
    __syncthreads();
    if (tid < NT && n0 + tid < g.Cout) {
      float S = 0.0f, Q = 0.0f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        S += red[0][p * NT + tid];
        Q += red[1][p * NT + tid];
      }
      // stats: (F, bricks, 2, Cout) float32
      float* sp = stats + ((long long)f * gridDim.x + blockIdx.x) * 2 * g.Cout;
      sp[n0 + tid] = S;
      sp[g.Cout + n0 + tid] = Q;
    }
  }
}

template <typename TO, int NT, bool STATS>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   void* stats, int F, Geometry g, cudaStream_t s) {
  constexpr int ZT = Tile<NT>::ZT, BX = 8 * Tile<NT>::XT;
  const int HX = BX + g.k - 1, HY = BY + g.k - 1, ZB = ZT + g.k - 1;
  const int main_bytes = ZB * HY * HX * CK * 2 + B_STAGES * CK * NT * 2;
  const int bytes = main_bytes > epilogue_bytes<NT>() ? main_bytes
                                                      : epilogue_bytes<NT>();
  if (bytes > SMEM_LIMIT - (STATS ? 2 * THREADS * 4 : 0))
    return cudaErrorInvalidValue;
  auto kernel = conv3d_kernel<TO, NT, STATS>;
  static int allowed = 48 * 1024;  // the default dynamic shared memory cap
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  g.nbx = (g.W + BX - 1) / BX;
  const int nbz = (g.D + ZT - 1) / ZT;
  dim3 grid(g.nbx * g.nby * nbz, (g.Cout + NT - 1) / NT, F);
  kernel<<<grid, THREADS, bytes, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (TO*)y, (float*)stats, g);
  return cudaGetLastError();
}

template <typename TO, bool STATS>
cudaError_t dispatch(int nt, const void* x, const void* w, const void* bias,
                     void* y, void* stats, int F, const Geometry& g,
                     cudaStream_t s) {
  if (nt == 32) return launch<TO, 32, STATS>(x, w, bias, y, stats, F, g, s);
  if (nt == 64) return launch<TO, 64, STATS>(x, w, bias, y, stats, F, g, s);
  return launch<TO, 128, STATS>(x, w, bias, y, stats, F, g, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// The kernel's tiling, which the wrapper mirrors (ops/conv3d.py): input
// channels per chunk, and the brick depth and width for an N tile of nt
// channels (32, 64 or 128; -1 for any other).
int nm_conv3d_chunk() { return CK; }
int nm_conv3d_brick_z(int nt) {
  return nt == 32 ? Tile<32>::ZT : nt == 64 ? Tile<64>::ZT
                                 : nt == 128 ? Tile<128>::ZT : -1;
}
int nm_conv3d_brick_x(int nt) {
  return nt == 32 ? 8 * Tile<32>::XT : nt == 64 ? 8 * Tile<64>::XT
                                     : nt == 128 ? 8 * Tile<128>::XT : -1;
}

// x: logical (F, D, H, W, Cin) bfloat16, element strides xs0..xs4.
// w: packed (ceil(Cout / nt), k^3, cin_pad / 8, nt, 8) bfloat16,
// contiguous, zero beyond (Cin, Cout); cin_pad a multiple of the chunk.
// bias: (Cout,) bfloat16, contiguous. y: logical (F, D, H, W, Cout),
// float32 (y_f32 != 0) or bfloat16, strides ys0..ys4. stats: NULL, or
// (F, bricks, 2, Cout) float32, bricks = ceil(D / brick_z) ceil(H / 8)
// ceil(W / brick_x), every entry written. Returns cudaGetLastError() after the
// launch.
int nm_conv3d(const void* x, const void* w, const void* bias, void* y,
              int y_f32, void* stats, int F, int D, int H, int W, int Cin,
              int Cout, int k, long long xs0, long long xs1, long long xs2,
              long long xs3, long long xs4, long long ys0, long long ys1,
              long long ys2, long long ys3, long long ys4, int cin_pad, int nt,
              int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (nm_conv3d_brick_z(nt) < 0 || k < 1 || k > MAX_K || k % 2 == 0 ||
      cin_pad % CK || cin_pad < Cin || F > 65535 ||
      (Cout + nt - 1) / nt > 65535)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || D == 0 || H == 0 || W == 0 || Cout == 0)
    return (int)cudaSuccess;
  const long long xv = xs0 | xs1 | xs2 | xs4, yv = ys0 | ys1 | ys2 | ys4;
  const int fast_in = xs3 == 1 && W % 8 == 0 && xv % 8 == 0 && aligned16(x);
  const int fast_out = ys3 == 1 && W % 8 == 0 && yv % 8 == 0 && aligned16(y);
  Geometry g{D, H, W, Cin, Cout, k, cin_pad, 0, (H + BY - 1) / BY,
             fast_in, fast_out,
             {xs0, xs1, xs2, xs3, xs4}, {ys0, ys1, ys2, ys3, ys4}};
  cudaStream_t s = (cudaStream_t)stream;
  const bool with_stats = stats != nullptr;
  cudaError_t err;
  if (y_f32)
    err = with_stats ? dispatch<float, true>(nt, x, w, bias, y, stats, F, g, s)
                     : dispatch<float, false>(nt, x, w, bias, y, stats, F, g, s);
  else
    err = with_stats
              ? dispatch<__nv_bfloat16, true>(nt, x, w, bias, y, stats, F, g, s)
              : dispatch<__nv_bfloat16, false>(nt, x, w, bias, y, stats, F, g,
                                               s);
  return (int)err;
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
