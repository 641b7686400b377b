// Forward flash attention for Hopper (sm_90a): causal / sliding-window /
// tanh-softcap, GQA, f32 or bf16 in, the input's dtype out.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, _flash_kernel) and computes what it computes:
//   s   = (q . k) * scale                  scale defaults to 1/sqrt(D)
//   s   = softcap * tanh(s / softcap)      before the mask, when on
//   keep: kpos <= qpos (causal), kpos > qpos - window (window), kpos < Sk
//   s   = -1e30 where not kept; online softmax with m, l and the output
//         accumulator in fp32, p = 0 where not kept
//   out = acc / max(l, 1e-30), cast to the input dtype (bf16: round to
//         nearest even)
// Query head h reads kv head h / (H / KVH). Positions count from 0 in
// both q and k. Any Sq, Sk >= 1 works (the Pallas kernel's 128-row
// blocks and its sq % blk == 0 assert are VMEM choices, not the
// contract); D <= 256.
//
// Layout: each tensor is (B, heads, S, D) addressed through its own
// batch, head and sequence strides (in elements) with D contiguous, so
// the model's (B, S, H, D) tensors are read and written in place.
//
// What bounds it: at the shapes the port runs (Gemma2 prefill, S = 8192,
// D = 256; the char-LM eval, S = 128, D = 24) the work is ~4*D
// operations per unmasked (q, k) pair against ~4*D bytes per row read
// once, so it is bound by operations, by far. This first design does
// them as fp32 FMAs on the CUDA cores (no tensor cores, no wgmma/TMA):
// its floor is the card's fp32 rate, not the bf16 tensor-core rate the
// bound is quoted against. What the design does about the operations:
//   - one CTA per (64-query tile, head, batch) of 256 threads, looping
//     over 64-key tiles; the key range is clipped to the causal/window
//     band of the query tile, so tiles outside it cost nothing;
//   - the query tile and each key/value tile are staged once in shared
//     memory as fp32 (zero past S and past D, D padded to 64/128/256),
//     so every global byte is read once per CTA and converted once;
//   - both products are register-tiled: each thread owns a 4x4 block of
//     the 64x64 score tile (16 FMAs per two 16-byte shared loads) and a
//     4 x (D/16) block of the output accumulator (4*D/16 FMAs per
//     D/64 + 1 16-byte loads); rows ty + 16i and keys tx + 16j keep the
//     shared-memory reads free of bank conflicts;
//   - the running max and sum live in shared memory, one row per four
//     threads, combined with warp shuffles.
// Shared memory is 218 KB at D = 256, above the 48 KB default: the
// launcher opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.
// No --use_fast_math: expf, tanhf and the final division are the
// accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // floats of padding per shared row
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int h, kvh, sq, sk, d;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;     // 0: no window
  float softcap;  // 0: no softcap
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool kept(const Params& p, int qpos, int kpos) {
  if (kpos >= p.sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : (u == 1 ? x.y : (u == 2 ? x.z : x.w));
}

// Bytes of dynamic shared memory for head width DP.
constexpr int smem_bytes(int dp) {
  return ((kBQ + 2 * kBK) * (dp + kPad) + kBQ * (kBK + kPad) + 3 * kBQ) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bhsd_kernel(const Params p) {
  constexpr int LD = DP + kPad;   // row stride of the q, k, v tiles
  constexpr int LP = kBK + kPad;  // row stride of the score tile
  constexpr int NC = DP / 64;     // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* s_s = v_s + kBK * LD;
  float* m_s = s_s + kBQ * LP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (p.h / p.kvh);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kv_head * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + head * p.o_sh;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.0f;
    if (q0 + r < p.sq && c < p.d) {
      x = to_f32(q[static_cast<long long>(q0 + r) * p.q_ss + c]);
    }
    q_s[r * LD + c] = x;
  }
  if (tid < kBQ) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.0f;
  }

  // the keys any row of this query tile can keep
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;

  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of k_s, v_s, s_s are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < p.sk && c < p.d) {
        kx = to_f32(k[static_cast<long long>(k0 + r) * p.k_ss + c]);
        vx = to_f32(v[static_cast<long long>(k0 + r) * p.v_ss + c]);
      }
      k_s[r * LD + c] = kx;
      v_s[r * LD + c] = vx;
    }
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * LD + d]);
        kb[i] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        s_s[r * LP + c] = kept(p, q0 + r, k0 + c) ? x : kMasked;
      }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = s_s + r * LP + part * 16;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e =
            kept(p, q0 + r, k0 + part * 16 + c) ? expf(row[c] - m_new) : 0.0f;
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // the row's four threads have read m_s[r]
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(&s_s[(ty + 16 * i) * LP + kk]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float4 vb = *reinterpret_cast<const float4*>(
              &v_s[(kk + u) * LD + 64 * j + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = component(pa[i], u);
            acc[i][j][0] = fmaf(pv, vb.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pv, vb.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pv, vb.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pv, vb.w, acc[i][j][3]);
          }
        }
      }
    }
  }
  __syncthreads();  // l_s is final (also when the tile kept no key)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* out = o + static_cast<long long>(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * j + 4 * tx + e;
        if (c < p.d) out[c] = from_f32<T>(acc[i][j][e] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(DP);
  // the opt-in is per device: set it on the current one before each launch
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bhsd_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, batch);
  flash_attention_bhsd_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const Params& p, int batch, cudaStream_t s) {
  if (p.d <= 64) return launch<T, 64>(p, batch, s);
  if (p.d <= 128) return launch<T, 128>(p, batch, s);
  return launch<T, 256>(p, batch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q, k, v, o,
// each as (batch, head, seq). window <= 0: none; softcap <= 0: none.
extern "C" int flash_attention_bhsd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch,
    int heads, int kv_heads, int sq, int sk, int d, const long long* strides,
    float scale, int causal, int window, float softcap, void* stream) {
  if (d < 1 || d > 256 || heads < 1 || kv_heads < 1 || heads % kv_heads ||
      sq < 1 || sk < 1 || batch < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.h = heads;
  p.kvh = kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.window = window > 0 ? window : 0;
  p.softcap = softcap > 0.0f ? softcap : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_for_width<float>(p, batch, s)
                              : launch_for_width<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(err);
}
