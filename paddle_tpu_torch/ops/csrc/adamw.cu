// Fused AdamW update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/fused.py:
//   _make_adamw -> _adamw_kernel   (adamw_kernel)
//
//   p, g  [n]  P = f32 | bf16 (g in p's dtype), p updated in place
//   m, v  [n]  f32 moments, updated in place
//
// Per element, in f32 (the TPU kernel's formula):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p - lr * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
// with c1 = 1 - b1^t and c2 = 1 - b2^t.  lr, b1, b2, eps and wd come by
// value.  c1 and c2 come by value too, unless the caller passes pointers to
// b1^t and b2^t on the device (the optimizer's state): then the kernel
// reads them and computes c = 1 - b^t itself, so the host never waits for
// the card to learn the step's bias correction.
//
// What bounds it on this card: 22 bytes per element for bf16 p (p and g
// read, p written: 6; m and v read and written: 16) and about 15
// operations, so it is bound by the bytes it moves (3.35 TB/s on an H100
// SXM).  A grid-stride loop over the flat tensor; the TPU's (rows, 1024)
// tiling has no counterpart, so any length goes through the kernel.
//
// The C entry allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename P>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const P* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, long long n, float lr, float b1, float b2,
             float eps, float wd, float c1, float c2,
             const float* __restrict__ pow1, const float* __restrict__ pow2) {
  if (pow1 != nullptr) {
    c1 = 1.f - *pow1;
    c2 = 1.f - *pow2;
  }
  const float one_b1 = 1.f - b1, one_b2 = 1.f - b2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every operation rounds on its own (the _rn intrinsics keep nvcc from
  // contracting a multiply and an add into one fma), in the order of the
  // TPU kernel and of the plain version, which is then matched bit for bit
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pf = to_f32(p[i]);
    const float gf = to_f32(g[i]);
    const float mn = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_b1, gf));
    const float vn = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(__fmul_rn(one_b2, gf), gf));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c2)), eps);
    const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(mn, c1), denom),
                                __fmul_rn(wd, pf));
    store(p + i, __fsub_rn(pf, __fmul_rn(lr, upd)));
    m[i] = mn;
    v[i] = vn;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  pow1 / pow2: device pointers to
// b1^t and b2^t (f32), or null to take c1 / c2 as given.
extern "C" int adamw_launch(void* p, const void* g, void* m, void* v,
                            long long n, float lr, float b1, float b2,
                            float eps, float wd, float c1, float c2,
                            const void* pow1, const void* pow2, int p_dtype,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  if ((pow1 == nullptr) != (pow2 == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* q1 = static_cast<const float*>(pow1);
  const float* q2 = static_cast<const float*>(pow2);
  if (p_dtype == 0)
    adamw_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g), mf, vf, n, lr,
        b1, b2, eps, wd, c1, c2, q1, q2);
  else if (p_dtype == 1)
    adamw_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g),
        mf, vf, n, lr, b1, b2, eps, wd, c1, c2, q1, q2);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
