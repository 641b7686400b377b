// The AdamW step of the port's optimizer (optim/optimizers.py adamw,
// update_) for Hopper (sm_90a): one pass over a parameter, its gradient
// and both moments.
//
// Replaces no TPU kernel: the reference's AdamW
// (repro/optim/optimizers.py) is plain jnp, which XLA fuses into one
// loop. Run eagerly, the same arithmetic (kernels/ref.py
// adamw_update_ref, the plain twin) is about twenty elementwise kernels
// per piece of a parameter, each reading and writing device memory:
// ~190 bytes a parameter where one pass needs 24. This kernel is that
// one pass, launched once per parameter through kernels/ops.py
// adamw_update_ (wrapper: kernels/adamw.py).
//
// Bit-for-bit contract with the plain twin as PyTorch runs it on the
// card. Each of the twin's elementwise ops computes in fp32 and rounds
// its result once, so the kernel performs the same fp32 operations in
// the same order, each with an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc may contract a * b + c into an
// FMA, and these it may not), with the Python scalars rounded from double
// to float on the host as PyTorch rounds a scalar operand (b1, 1 - b1,
// b2, 1 - b2, eps, weight_decay, -lr), and rounds to bf16 (to nearest
// even) wherever the twin casts:
//   g  = G(g * G(mask))                                    (with a mask)
//   mu = M(b1 * mu + (1 - b1) * g)
//   nu = M(b2 * nu + (1 - b2) * (g * g))
//   s  = (mu / bc1) / (sqrt(nu / bc2) + eps)
//   s  = s + weight_decay * p                 (decay: parameters of ndim >= 2)
//   u  = P(-lr * s);  u = P(u * P(mask))                   (with a mask)
//   p  = P(p + u)
// G, M and P round to the gradient's, the moments' and the parameter's
// dtype (fp32: no rounding). bc1 and bc2 are 0-d fp32 tensors on the
// card (the bias corrections, worked out once a step by the optimizer),
// read here, so the step needs no host read. The gradient is read, not
// written: the twin masks it in its own buffer, which the optimizer frees
// right after.
//
// What bounds it: bytes. An element reads its gradient, parameter and
// both moments and writes the last three (24 bytes for bf16 weights with
// fp32 moments and gradient) for ~15 fp32 operations, far below the
// card's ridge, and the arrays are many times the 50 MB L2. So the design
// moves each byte once and nothing else: each thread takes 8 consecutive
// elements a step with 16-byte loads and stores (two per fp32 array, one
// per bf16 array) and streaming cache hints (ld.global.cs /
// st.global.cs: every byte is touched once); the grid is as many blocks
// as the card holds resident, striding over the vectors, so that every
// SM has ~100 KB of loads in flight; no shared memory and no temporary
// in device memory. A count that is not a multiple of 8 ends in a scalar
// loop; a base not 16-byte aligned sends every element through it. The
// mask, broadcast over a parameter's leading dims (one value for each
// `mask_inner` consecutive elements) or 0-d, is read through the
// read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;           // elements a thread takes per step
constexpr int kMaxDevices = 64;

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr;
  int decay;
};

// Loads and stores of one dtype, widened to and narrowed from fp32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float v[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float v[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void store1(float* p, float v) {
    __stcs(p, v);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  // a bf16 is the high half of the fp32 of the same value
  static __device__ __forceinline__ float widen(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  static __device__ __forceinline__ uint32_t narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float v[8]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // little-endian: element 2i is low
      v[2 * i] = widen(w[i] & 0xffffu);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p,
                                                const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = narrow(v[2 * i]) | (narrow(v[2 * i + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return widen(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(narrow(v)));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One element's step (see the header): g, p, mu and nu come in as the
// fp32 values of their stored dtypes, and p, mu and nu leave as the
// values to store (already rounded to their dtypes).
template <typename G, typename P, typename M>
__device__ __forceinline__ void adamw_one(float g, float& p, float& mu,
                                          float& nu, bool masked, float mask,
                                          float bc1, float bc2,
                                          const Hyper& h) {
  if (masked) g = Io<G>::round(__fmul_rn(g, Io<G>::round(mask)));
  mu = Io<M>::round(__fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.one_minus_b1, g)));
  nu = Io<M>::round(__fadd_rn(__fmul_rn(h.b2, nu),
                              __fmul_rn(h.one_minus_b2, __fmul_rn(g, g))));
  float s = __fdiv_rn(__fdiv_rn(mu, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps));
  if (h.decay) s = __fadd_rn(s, __fmul_rn(h.weight_decay, p));
  float u = Io<P>::round(__fmul_rn(h.neg_lr, s));
  if (masked) u = Io<P>::round(__fmul_rn(u, Io<P>::round(mask)));
  p = Io<P>::round(__fadd_rn(p, u));
}

// n elements: n_vec vectors of kVec (16-byte aligned bases), then the
// rest one at a time; mask: nullptr, or one value per mask_inner
// elements.
template <typename G, typename P, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const G* __restrict__ g, P* __restrict__ p,
                    M* __restrict__ mu, M* __restrict__ nu,
                    const float* __restrict__ mask, int64_t mask_inner,
                    const float* __restrict__ bc1_ptr,
                    const float* __restrict__ bc2_ptr, int64_t n,
                    int64_t n_vec, Hyper h) {
  const float bc1 = __ldg(bc1_ptr);
  const float bc2 = __ldg(bc2_ptr);
  const bool masked = mask != nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  for (int64_t v = first; v < n_vec; v += stride) {
    const int64_t i0 = v * kVec;
    float gv[kVec], pv[kVec], mv[kVec], nv[kVec], mk[kVec];
    Io<G>::load8(g + i0, gv);
    Io<P>::load8(p + i0, pv);
    Io<M>::load8(mu + i0, mv);
    Io<M>::load8(nu + i0, nv);
    if (masked) {
      const int64_t row = i0 / mask_inner;
      if (i0 + kVec <= (row + 1) * mask_inner) {    // one mask row
        const float m = __ldg(mask + row);
#pragma unroll
        for (int j = 0; j < kVec; ++j) mk[j] = m;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) mk[j] = __ldg(mask + (i0 + j) / mask_inner);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      adamw_one<G, P, M>(gv[j], pv[j], mv[j], nv[j], masked,
                         masked ? mk[j] : 0.0f, bc1, bc2, h);
    }
    Io<P>::store8(p + i0, pv);
    Io<M>::store8(mu + i0, mv);
    Io<M>::store8(nu + i0, nv);
  }
  for (int64_t i = n_vec * kVec + first; i < n; i += stride) {
    float pi = Io<P>::load1(p + i), mi = Io<M>::load1(mu + i),
          ni = Io<M>::load1(nu + i);
    adamw_one<G, P, M>(Io<G>::load1(g + i), pi, mi, ni, masked,
                       masked ? __ldg(mask + i / mask_inner) : 0.0f, bc1,
                       bc2, h);
    Io<P>::store1(p + i, pi);
    Io<M>::store1(mu + i, mi);
    Io<M>::store1(nu + i, ni);
  }
}

// Resident blocks of the kernel on the current card: SMs x blocks an SM
// holds (both read once per card and kernel; the host reads no device
// state).
template <typename G, typename P, typename M>
int resident_blocks() {
  static int per_sm = 0;
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_update_kernel<G, P, M>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int count = 0;
  if (dev >= 0 && dev < kMaxDevices) {
    if (sms[dev] == 0) {
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    }
    count = sms[dev];
  } else {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return per_sm * (count > 0 ? count : 1);
}

template <typename G, typename P, typename M>
int launch(const void* g, void* p, void* mu, void* nu, const float* mask,
           int64_t mask_inner, const float* bc1, const float* bc2, int64_t n,
           const Hyper& h, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(g)
                          | reinterpret_cast<uintptr_t>(p)
                          | reinterpret_cast<uintptr_t>(mu)
                          | reinterpret_cast<uintptr_t>(nu);
  const int64_t n_vec = bases % 16 == 0 ? n / kVec : 0;
  const int64_t work = n_vec + (n - n_vec * kVec);   // a thread's items
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t resident = resident_blocks<G, P, M>();
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  adamw_update_kernel<G, P, M><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const G*>(g), static_cast<P*>(p), static_cast<M*>(mu),
      static_cast<M*>(nu), mask, mask_inner, bc1, bc2, n, n_vec, h);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes (kernels/adamw.py DTYPES): 0 fp32, 1 bf16
template <typename G, typename P>
int launch_m(int m_dtype, const void* g, void* p, void* mu, void* nu,
             const float* mask, int64_t mask_inner, const float* bc1,
             const float* bc2, int64_t n, const Hyper& h,
             cudaStream_t stream) {
  if (m_dtype == 0) {
    return launch<G, P, float>(g, p, mu, nu, mask, mask_inner, bc1, bc2, n,
                               h, stream);
  }
  if (m_dtype == 1) {
    return launch<G, P, __nv_bfloat16>(g, p, mu, nu, mask, mask_inner, bc1,
                                       bc2, n, h, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename G>
int launch_p(int p_dtype, int m_dtype, const void* g, void* p, void* mu,
             void* nu, const float* mask, int64_t mask_inner,
             const float* bc1, const float* bc2, int64_t n, const Hyper& h,
             cudaStream_t stream) {
  if (p_dtype == 0) {
    return launch_m<G, float>(m_dtype, g, p, mu, nu, mask, mask_inner, bc1,
                              bc2, n, h, stream);
  }
  if (p_dtype == 1) {
    return launch_m<G, __nv_bfloat16>(m_dtype, g, p, mu, nu, mask,
                                      mask_inner, bc1, bc2, n, h, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One AdamW step of n elements in place (p, mu, nu), reading g, the mask
// (nullptr: none) and the bias corrections bc1, bc2 (0-d fp32 on the
// card); decay != 0 adds weight_decay * p. Returns cudaGetLastError().
int adamw_update_launch(const void* g, void* p, void* mu, void* nu,
                        const void* mask, const void* bc1, const void* bc2,
                        int64_t n, int64_t mask_inner, int g_dtype,
                        int p_dtype, int m_dtype, float b1,
                        float one_minus_b1, float b2, float one_minus_b2,
                        float eps, float weight_decay, float neg_lr,
                        int decay, cudaStream_t stream) {
  if (n <= 0 || (mask != nullptr && mask_inner <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay,
                neg_lr, decay};
  const float* m = static_cast<const float*>(mask);
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  if (g_dtype == 0) {
    return launch_p<float>(p_dtype, m_dtype, g, p, mu, nu, m, mask_inner, c1,
                           c2, n, h, stream);
  }
  if (g_dtype == 1) {
    return launch_p<__nv_bfloat16>(p_dtype, m_dtype, g, p, mu, nu, m,
                                   mask_inner, c1, c2, n, h, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
