// Pass 2 of kernel K4 (the fused conv + GroupNorm + LeakyReLU stage): the
// normalisation, affine and activation of the stored conv output.
//
// Replaces: neural_marionette_tpu/ops/pallas/fusedstage_kernel.py,
//   fused_stage (:185-191), the elementwise tail that the JAX package leaves
//   to XLA as one fused read and write of y.
//
// Semantics (ops/fusedstage.normalize_plain, in its order of rounding):
//   z = ((y - mean) * inv) * scale + bias     in float32,
//   out = z > 0 ? z : z * 0.01                 (LeakyReLU 0.01),
// rounded once to y's dtype (float32 or bfloat16). mean and inv are per
// (frame, channel) (the group's values repeated over its channels, from
// the wrapper's reduce of pass 1's moment partials), scale and bias per
// channel, all float32. The _rn intrinsics keep nvcc from contracting the
// multiply and add into an FMA, so every step rounds as PyTorch's separate
// elementwise ops do.
//
// Layout: y and out are addressed through element strides of the logical
// (F, D, H, W, C) view. Where both are NCDHW-dense with D H W % 8 == 0 and
// 16-byte aligned (the conv route's activations), a thread reads and writes
// 8 neighbouring voxels of one channel with 16-byte accesses; any other
// layout takes one element per thread through the strides (a shape-based
// choice, never a fallback on failure).
//
// Bound on the H100: bytes. One read and one write of y: at the decoder's
// stage 3 (40 x 64^3 x 32 bf16) 1.34 GB, 0.40 ms at 3.35 TB/s; four
// float32 operations and a compare per element are far below the rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const float* mean;   // (F, C)
  const float* inv;    // (F, C)
  const float* scale;  // (C,)
  const float* bias;   // (C,)
};

__device__ __forceinline__ float apply(float v, float m, float r, float s,
                                       float b) {
  float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), r), s), b);
  return z > 0.0f ? z : __fmul_rn(z, 0.01f);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low, b high
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// NCDHW-dense: rows of S = D H W voxels per (frame, channel); one thread
// per 8 voxels of a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
groupnorm_act_vec_kernel(const T* __restrict__ y, T* __restrict__ out,
                         Params p, int C, long long S8, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long fc = i / S8;  // frame * C + channel
  const int c = (int)(fc % C);
  const float m = __ldg(p.mean + fc), r = __ldg(p.inv + fc);
  const float s = __ldg(p.scale + c), b = __ldg(p.bias + c);
  float v[8];
  load8(y + i * 8, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = apply(v[j], m, r, s, b);
  store8(out + i * 8, v);
}

// any layout: one element per thread through the strides
template <typename T>
__global__ void __launch_bounds__(THREADS)
groupnorm_act_kernel(const T* __restrict__ y, T* __restrict__ out, Params p,
                     int D, int H, int W, int C, long long n,
                     long long ys0, long long ys1, long long ys2,
                     long long ys3, long long ys4, long long os0,
                     long long os1, long long os2, long long os3,
                     long long os4) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  long long r = i / C;
  const int x = (int)(r % W);
  r /= W;
  const int yy = (int)(r % H);
  r /= H;
  const int z = (int)(r % D);
  const long long f = r / D;
  const long long fc = f * C + c;
  const float v = load1(y + f * ys0 + z * ys1 + yy * ys2 + x * ys3 + c * ys4);
  store1(out + f * os0 + z * os1 + yy * os2 + x * os3 + c * os4,
         apply(v, __ldg(p.mean + fc), __ldg(p.inv + fc), __ldg(p.scale + c),
               __ldg(p.bias + c)));
}

bool ncdhw_dense(long long s0, long long s1, long long s2, long long s3,
                 long long s4, int D, int H, int W, int C) {
  const long long S = (long long)D * H * W;
  return s3 == 1 && s2 == W && s1 == (long long)H * W && s4 == S &&
         s0 == S * C;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* y, void* out, const Params& p, int F, int D,
                   int H, int W, int C, const long long* ys,
                   const long long* os, cudaStream_t s) {
  const long long S = (long long)D * H * W;
  if (S % 8 == 0 && aligned16(y) && aligned16(out) &&
      ncdhw_dense(ys[0], ys[1], ys[2], ys[3], ys[4], D, H, W, C) &&
      ncdhw_dense(os[0], os[1], os[2], os[3], os[4], D, H, W, C)) {
    const long long n = (long long)F * C * (S / 8);
    groupnorm_act_vec_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS),
                                  THREADS, 0, s>>>(
        (const T*)y, (T*)out, p, C, S / 8, n);
  } else {
    const long long n = (long long)F * C * S;
    groupnorm_act_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS),
                              THREADS, 0, s>>>(
        (const T*)y, (T*)out, p, D, H, W, C, n, ys[0], ys[1], ys[2], ys[3],
        ys[4], os[0], os[1], os[2], os[3], os[4]);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y, out: logical (F, D, H, W, C), float32 (y_bf16 == 0) or bfloat16, element
// strides ys0..ys4 and os0..os4 (out may not overlap y). mean, inv: (F, C)
// float32, contiguous; scale, bias: (C,) float32, contiguous. Returns
// cudaGetLastError() after the launch.
int nm_groupnorm_act(const void* y, int y_bf16, void* out, const void* mean,
                     const void* inv, const void* scale, const void* bias,
                     int F, int D, int H, int W, int C, long long ys0,
                     long long ys1, long long ys2, long long ys3,
                     long long ys4, long long os0, long long os1,
                     long long os2, long long os3, long long os4, int device,
                     void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long n = (long long)F * C * D * H * W;
  if (n == 0) return (int)cudaSuccess;
  if ((n + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Params p{(const float*)mean, (const float*)inv, (const float*)scale,
                 (const float*)bias};
  const long long ys[5] = {ys0, ys1, ys2, ys3, ys4};
  const long long os[5] = {os0, os1, os2, os3, os4};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(y_bf16 ? launch<__nv_bfloat16>(y, out, p, F, D, H, W, C, ys,
                                               os, s)
                      : launch<float>(y, out, p, F, D, H, W, C, ys, os, s));
}

const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
