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
// Three variants; the caller picks one from the dtype and D alone:
//
// 1. mma_bf16 (every bf16 call: Gemma2 prefill, B 1, S 8192, H 16 over
//    KVH 8, D 256). Bound by operations: ~4*D per unmasked (q, k) pair
//    against ~4*D bytes per row read once. Both products run on the
//    tensor cores as mma.sync m16n8k16 bf16 with fp32 accumulation (not
//    wgmma: the warpgroup version is the next step). One CTA of four
//    warps serves 64 query rows, 16 per warp; the Q tile and a
//    double-buffered ring of K/V tiles sit in shared memory as bf16
//    (rows padded by 16 bytes, so ldmatrix reads are conflict-free),
//    fed by cp.async while the previous tile computes. Q fragments are
//    re-read from shared memory for every key tile (at D = 256 the
//    output accumulator alone is 128 registers a thread). Keys per tile:
//    32 at D = 256 (101 KB of shared memory, two CTAs per SM), 64
//    below. The scores' C fragments become the PV product's A fragments
//    in registers. P goes to the tensor cores in bf16, which one
//    rounding would put ~2^-9 off per weight, outside the bound near
//    zero; so P is split into hi = bf16(p) and lo = bf16(p - hi) and
//    both products accumulate into one fp32 accumulator (p is kept to
//    ~2^-17; V is bf16 and exact): PV costs twice, the kernel 1.5x the
//    bound's operations. Query tiles run longest first (causal: the
//    last tiles), so the grid's tail is short.
// 2. rows_f32 (f32, D <= 32: the char-LM eval, B 64, S 32 or 128, H 8,
//    D 24). Bound by bytes at these shapes, and by latency in practice:
//    the whole call is a few microseconds. Four lanes per query row,
//    each with the q row and its own fp32 accumulator in registers (D
//    padded to a multiple of 8: 24 stays 24), running the online
//    softmax over every fourth key, merged by shuffles at the end; 64
//    rows a CTA: a query tile is min(S, 64) rows, and where S < 64 one
//    CTA serves several (batch, head) pairs, so S = 32 runs two pairs
//    per CTA. One thread per key row stages a tile of up to 64 keys a
//    pair (16-byte loads, all in flight at once) into shared memory,
//    read back as broadcasts. fp32 FMAs: TF32 cannot meet 2e-5.
// 3. tiled_f32 (f32, D > 32; only the sweep runs it). The first design:
//    fp32 FMAs on the CUDA cores, each of 256 threads owning a 4x4 block
//    of a 64x64 score tile and a 4 x D/16 block of the output, fp32
//    tiles of q, k, v in shared memory (218 KB at D = 256).
//
// All variants clip the key range to each query tile's causal / window
// band, so tiles outside it cost nothing, and zero-fill rows past S and
// columns past D on chip. Shared memory above 48 KB is opted into once
// per device and kernel instantiation.
//
// Which functions are exact: no --use_fast_math. expf and tanhf are the
// library's accurate versions (max 2 ulp); the final division is the
// correctly rounded one; s / softcap is taken as s * (1 / softcap) with
// the reciprocal rounded to fp32 on the host (within 1.5 ulp of the
// division, far inside the bounds). bf16 inputs are exact in fp32, and
// so are their products in the tensor cores; the tensor cores' fp32
// sums are taken in another order (and rounding) than the plain
// version's, as are the CUDA-core sums of the f32 variants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kMaxDevices = 64;

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
  int window;         // 0: no window
  float softcap;      // 0: no softcap
  float inv_softcap;  // fp32(1 / softcap)
  int vec;            // 1: every row start is 16-byte aligned and d is a
                      // whole number of 16-byte chunks
};

__device__ __forceinline__ bool kept(const Params& p, int qpos, int kpos) {
  if (kpos >= p.sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// scale, then the softcap (when on)
__device__ __forceinline__ float score(const Params& p, float dot) {
  float x = dot * p.scale;
  if (p.softcap > 0.0f) x = p.softcap * tanhf(x * p.inv_softcap);
  return x;
}

// the keys any row of the query rows [q0, q_last] can keep
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_last,
                                          int* k_begin, int* k_end) {
  *k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
}

// ---------------------------------------------------------------------------
// 1. mma_bf16: tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per CTA

template <int DP>
struct MmaTile {
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per tile
  static constexpr int LD = DP + 8;  // bf16 per shared row (+16 bytes)
  static constexpr int Q = kMmaBQ * LD;
  static constexpr int KV = BK * LD;
  // Q, then two stages of (K, V)
  static constexpr int bytes = (Q + 4 * KV) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), packed as mma operands
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  *hi = pack_bf16(h);
  *lo = pack_bf16(__floats2bfloat162_rn(p0 - __low2float(h),
                                        p1 - __high2float(h)));
}

// Stage rows [row0, row0 + ROWS) of one (batch, head) of a bf16 tensor
// into shared memory (row stride LD), zero past `rows` and past d.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int row0,
                                               int rows, const Params& p) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    __nv_bfloat16* to = dst + r * LD + c;
    const bool row_ok = row0 + r < rows;
    const __nv_bfloat16* from = src + static_cast<long long>(row0 + r) * ss + c;
    if (p.vec) {
      const bool ok = row_ok && c < p.d;
      cp_async16(to, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        to[e] = row_ok && c + e < p.d ? from[e] : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_mma_bf16_kernel(const Params p) {
  using T = MmaTile<DP>;
  constexpr int BK = T::BK;
  constexpr int LD = T::LD;
  constexpr int NT = BK / 8;   // score n-tiles (8 keys each) per warp
  constexpr int OT = DP / 8;   // output n-tiles (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + T::Q;  // stage s: K at 2s, V at 2s + 1

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qtiles = gridDim.y;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.y)) * kMmaBQ;
  const int head = blockIdx.x % p.h;
  const int b = blockIdx.x / p.h;
  const int kv_head = head / (p.h / p.kvh);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + head * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + kv_head * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + kv_head * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                     head * p.o_sh;

  const int q_last = min(q0 + kMmaBQ, p.sq) - 1;
  int k_begin, k_end;
  key_range(p, q0, q_last, &k_begin, &k_end);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_rows_bf16<kMmaBQ, DP, LD>(q_s, q, p.q_ss, q0, p.sq, p);
  if (n_kt > 0) {
    load_rows_bf16<BK, DP, LD>(kv_s, k, p.k_ss, k_begin, p.sk, p);
    load_rows_bf16<BK, DP, LD>(kv_s + T::KV, v, p.v_ss, k_begin, p.sk, p);
  }
  cp_async_commit();

  // this thread's rows: ra (accumulator entries 0, 1) and ra + 8 (2, 3)
  const int ra = q0 + warp * 16 + g;
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_row[2] = {kMasked, kMasked};
  float l_row[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A from Q rows, B from K rows, B^T from V rows
  const __nv_bfloat16* qa =
      q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int kb_off = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
  const int vb_off = (((lane / 8) % 2) * 8 + lane % 8) * LD + (lane / 16) * 8;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = k_begin + it * BK;
    const __nv_bfloat16* k_s = kv_s + (it % 2) * 2 * T::KV;
    const __nv_bfloat16* v_s = k_s + T::KV;
    if (it + 1 < n_kt) {
      __nv_bfloat16* nk = kv_s + ((it + 1) % 2) * 2 * T::KV;
      load_rows_bf16<BK, DP, LD>(nk, k, p.k_ss, k0 + BK, p.sk, p);
      load_rows_bf16<BK, DP, LD>(nk + T::KV, v, p.v_ss, k0 + BK, p.sk, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T over this tile: 16 rows x BK keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + j * 8 * LD + kb_off + kk);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; the tile needs the mask only where it meets
    // the end of the keys or the edge of the causal / window band
    const bool edge = k0 + BK > p.sk ||
                      (p.causal && k0 + BK - 1 > q0) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = score(p, s[j][e]);
        if (edge && !kept(p, ra + (e / 2) * 8, k0 + j * 8 + 2 * t + e % 2)) {
          x = kMasked;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_row[r], mx[r]);
      corr[r] = expf(m_row[r] - m_new[r]);
      m_row[r] = m_new[r];
      l_row[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p = 0 where not kept (a row with nothing kept yet has
        // m = -1e30 too, so the score is tested, not the difference)
        const float pe =
            s[j][e] == kMasked ? 0.0f : expf(s[j][e] - m_new[e / 2]);
        s[j][e] = pe;
        l_row[e / 2] += pe;
      }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V, P split into bf16 hi + lo
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], &hi[0], &lo[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], &hi[1], &lo[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], &hi[2], &lo[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], &hi[3], &lo[3]);
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + kc * 16 * LD + vb_off + j * 8);
        mma_bf16(acc[j], hi, bv[0], bv[1]);
        mma_bf16(acc[j], lo, bv[0], bv[1]);
        mma_bf16(acc[j + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[j + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is read; the next prefetch may land
  }
  cp_async_wait<0>();  // no key tile: the Q copy is still in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + r * 8;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l_row[r], 1e-30f);
    __nv_bfloat16* out = o + static_cast<long long>(row) * p.o_ss;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t;
      const float x0 = acc[j][2 * r] / denom;
      const float x1 = acc[j][2 * r + 1] / denom;
      if (p.vec) {
        if (c < p.d) {  // d is a multiple of 8 here: c + 1 < d too
          *reinterpret_cast<__nv_bfloat162*>(out + c) =
              __floats2bfloat162_rn(x0, x1);
        }
      } else {
        if (c < p.d) out[c] = __float2bfloat16_rn(x0);
        if (c + 1 < p.d) out[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. rows_f32: four lanes per query row, fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowsRows = 64;     // query rows per CTA
constexpr int kRowsLanes = 4;     // lanes per row, each on every 4th key
constexpr int kRowsThreads = kRowsRows * kRowsLanes;
constexpr int kRowsKT = 64;       // keys per staged tile (per pair)
constexpr int kRowsMaxD = 32;
constexpr int kRowsChunk = 8;     // a lane's keys per online-softmax step

// Read `n` floats of a row into `dst` (zero past d): 16-byte loads
// where the rows are aligned (p.vec), else one float at a time. All
// loads are issued before any is used.
template <int DP>
__device__ __forceinline__ void load_row_f32(float (&dst)[DP],
                                             const float* src, bool ok,
                                             const Params& p) {
  if (ok && p.vec) {
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 x = c < p.d ? *reinterpret_cast<const float4*>(src + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[c] = x.x;
      dst[c + 1] = x.y;
      dst[c + 2] = x.z;
      dst[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) dst[c] = ok && c < p.d ? src[c] : 0.0f;
  }
}

// grid.x = n_qtiles * n_groups, longest query tiles first; each CTA
// serves `pairs` (batch, head) pairs of `tile` query rows each and stages
// `kte` keys of each pair per step: pairs * kte <= 64, so each of the
// first 64 threads stages at most one K row and one V row per step. The
// four lanes of a row (neighbours in a warp) each run the online softmax
// over every fourth key with their own m, l and accumulator, merged with
// shuffles at the end. DP = D rounded up to 8.
template <int DP>
__global__ void __launch_bounds__(kRowsThreads)
    flash_rows_f32_kernel(const Params p, int n_pairs, int tile, int pairs,
                          int n_groups, int kte) {
  __shared__ __align__(16) float k_s[kRowsRows * DP];
  __shared__ __align__(16) float v_s[kRowsRows * DP];
  const int n_qtiles = gridDim.x / n_groups;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / n_groups;
  const int group = blockIdx.x % n_groups;
  const int q0 = qt * tile;
  const int q_last = min(q0 + tile, p.sq) - 1;
  int k_begin, k_end;
  key_range(p, q0, q_last, &k_begin, &k_end);
  const int g = p.h / p.kvh;

  // this thread's query row and lane
  const int row = threadIdx.x / kRowsLanes;
  const int lane = threadIdx.x % kRowsLanes;
  const int pl = row / tile;
  const int qpos = q0 + row % tile;
  const int pair = group * pairs + pl;
  const bool active = pl < pairs && pair < n_pairs && qpos <= q_last;
  const int b = pair / p.h, head = pair % p.h;
  // the key row this thread stages (threads 0 .. pairs * kte - 1)
  const int sp = threadIdx.x / kte, sj = threadIdx.x % kte;
  const int s_pair = group * pairs + sp;
  const bool stages = sp < pairs && s_pair < n_pairs;
  const long long k_off = stages ? (s_pair / p.h) * p.k_sb +
                                       ((s_pair % p.h) / g) * p.k_sh
                                 : 0;
  const long long v_off = stages ? (s_pair / p.h) * p.v_sb +
                                       ((s_pair % p.h) / g) * p.v_sh
                                 : 0;

  float qr[DP], acc[DP];
  load_row_f32<DP>(qr,
                   static_cast<const float*>(p.q) + b * p.q_sb +
                       head * p.q_sh + static_cast<long long>(qpos) * p.q_ss,
                   active, p);
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.0f;
  float m = kMasked, l = 0.0f;

  // this row's last key (causal) bounds its lanes' loops
  const int my_end = p.causal ? min(k_end, qpos + 1) : k_end;
  for (int k0 = k_begin; k0 < k_end; k0 += kte) {
    float kx[DP], vx[DP];
    const bool ok = stages && k0 + sj < p.sk;
    const long long kpos = k0 + sj;
    load_row_f32<DP>(kx, static_cast<const float*>(p.k) + k_off +
                             kpos * p.k_ss, ok, p);
    load_row_f32<DP>(vx, static_cast<const float*>(p.v) + v_off +
                             kpos * p.v_ss, ok, p);
    __syncthreads();  // the previous tile's reads are done
    if (threadIdx.x < pairs * kte) {
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        *reinterpret_cast<float4*>(&k_s[threadIdx.x * DP + c]) =
            make_float4(kx[c], kx[c + 1], kx[c + 2], kx[c + 3]);
        *reinterpret_cast<float4*>(&v_s[threadIdx.x * DP + c]) =
            make_float4(vx[c], vx[c + 1], vx[c + 2], vx[c + 3]);
      }
    }
    __syncthreads();
    if (!active) continue;
    const int n_keys = min(kte, my_end - k0);
    const float* kt = k_s + pl * kte * DP;
    const float* vt = v_s + pl * kte * DP;
    for (int j0 = lane; j0 < n_keys; j0 += kRowsLanes * kRowsChunk) {
      float s[kRowsChunk];
      float mx = kMasked;
#pragma unroll
      for (int u = 0; u < kRowsChunk; ++u) {
        const int j = j0 + kRowsLanes * u;
        float x = kMasked;
        if (j < n_keys && kept(p, qpos, k0 + j)) {
          const float4* kr = reinterpret_cast<const float4*>(kt + j * DP);
          float dot = 0.0f;
#pragma unroll
          for (int c4 = 0; c4 < DP / 4; ++c4) {
            const float4 kv = kr[c4];
            dot = fmaf(qr[4 * c4], kv.x, dot);
            dot = fmaf(qr[4 * c4 + 1], kv.y, dot);
            dot = fmaf(qr[4 * c4 + 2], kv.z, dot);
            dot = fmaf(qr[4 * c4 + 3], kv.w, dot);
          }
          x = score(p, dot);
        }
        s[u] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] *= corr;
#pragma unroll
      for (int u = 0; u < kRowsChunk; ++u) {
        const float e = s[u] == kMasked ? 0.0f : expf(s[u] - m_new);
        l += e;
        if (e != 0.0f) {
          const float4* vr = reinterpret_cast<const float4*>(
              vt + (j0 + kRowsLanes * u) * DP);
#pragma unroll
          for (int c4 = 0; c4 < DP / 4; ++c4) {
            const float4 vv = vr[c4];
            acc[4 * c4] = fmaf(e, vv.x, acc[4 * c4]);
            acc[4 * c4 + 1] = fmaf(e, vv.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(e, vv.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(e, vv.w, acc[4 * c4 + 3]);
          }
        }
      }
    }
  }

  // merge the row's four lanes: a lane that kept nothing has m = -1e30
  // and weighs 0 (or 1 with l = 0 when no lane kept anything)
  float m_all = m;
#pragma unroll
  for (int off = 1; off < kRowsLanes; off *= 2) {
    m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
  }
  const float w = expf(m - m_all);
  l *= w;
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] *= w;
#pragma unroll
  for (int off = 1; off < kRowsLanes; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
  if (!active) return;
  float* out = static_cast<float*>(p.o) + b * p.o_sb + head * p.o_sh +
               static_cast<long long>(qpos) * p.o_ss;
  const float denom = fmaxf(l, 1e-30f);
  // lane i writes the row's columns 4i, 4i + 16 (+ 1..3 each)
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    if (c >= p.d || (c / 4) % kRowsLanes != lane) continue;
    const float x0 = acc[c] / denom, x1 = acc[c + 1] / denom;
    const float x2 = acc[c + 2] / denom, x3 = acc[c + 3] / denom;
    if (p.vec) {
      *reinterpret_cast<float4*>(out + c) = make_float4(x0, x1, x2, x3);
    } else {
      out[c] = x0;
      if (c + 1 < p.d) out[c + 1] = x1;
      if (c + 2 < p.d) out[c + 2] = x2;
      if (c + 3 < p.d) out[c + 3] = x3;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. tiled_f32: register-tiled fp32 FMAs (the first design)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // floats of padding per shared row

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : (u == 1 ? x.y : (u == 2 ? x.z : x.w));
}

// Bytes of dynamic shared memory for head width DP.
constexpr int tiled_smem_bytes(int dp) {
  return ((kBQ + 2 * kBK) * (dp + kPad) + kBQ * (kBK + kPad) + 3 * kBQ) *
         static_cast<int>(sizeof(float));
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tiled_f32_kernel(const Params p) {
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (p.h / p.kvh);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + head * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kv_head * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + head * p.o_sh;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.0f;
    if (q0 + r < p.sq && c < p.d) {
      x = q[static_cast<long long>(q0 + r) * p.q_ss + c];
    }
    q_s[r * LD + c] = x;
  }
  if (tid < kBQ) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int k_begin, k_end;
  key_range(p, q0, q_last, &k_begin, &k_end);

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
        kx = k[static_cast<long long>(k0 + r) * p.k_ss + c];
        vx = v[static_cast<long long>(k0 + r) * p.v_ss + c];
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
        const float x = score(p, s[i][j]);
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
    float* out = o + static_cast<long long>(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * j + 4 * tx + e;
        if (c < p.d) out[c] = acc[i][j][e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit to `bytes`, once per
// device for each kernel instantiation (the attribute is per device).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && cached) done[dev] = true;
  return err;
}

template <int DP>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int bytes = MmaTile<DP>::bytes;
  const cudaError_t err = opt_in(flash_mma_bf16_kernel<DP>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.h, (p.sq + kMmaBQ - 1) / kMmaBQ);
  flash_mma_bf16_kernel<DP><<<grid, kMmaThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_rows(const Params& p, int batch, cudaStream_t stream) {
  const int n_pairs = batch * p.h;
  const int tile = std::min(p.sq, kRowsRows);
  const int pairs = kRowsRows / tile;
  const int n_groups = (n_pairs + pairs - 1) / pairs;
  const int n_qtiles = (p.sq + tile - 1) / tile;
  // keys staged per pair: pairs * kte <= 64 rows of k_s / v_s
  const int kte = std::min(kRowsKT, std::max(1, kRowsRows / pairs));
  flash_rows_f32_kernel<DP>
      <<<n_qtiles * n_groups, kRowsThreads, 0, stream>>>(
          p, n_pairs, tile, pairs, n_groups, kte);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_tiled(const Params& p, int batch, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int bytes = tiled_smem_bytes(DP);
  const cudaError_t err = opt_in(flash_tiled_f32_kernel<DP>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, batch);
  flash_tiled_f32_kernel<DP><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The call's arguments, packed by the Python wrapper as 8-byte fields
// (struct.pack("<25q2d")), so a launch costs one ctypes call.
struct FlashArgs {
  long long q, k, v, o;  // device pointers
  long long variant;     // 0: mma_bf16, 1: rows_f32, 2: tiled_f32
  long long batch, heads, kv_heads, sq, sk, d;
  long long strides[12];  // q, k, v, o, each (batch, head, seq), elements
  long long causal, window;  // window <= 0: none
  double scale, softcap;     // softcap <= 0: none
};

bool aligned16(long long ptr) { return ptr % 16 == 0; }

}  // namespace

// Variants: 0 = mma_bf16 (bf16, any D <= 256), 1 = rows_f32 (f32,
// D <= 32), 2 = tiled_f32 (f32, D <= 256). Returns a cudaError_t.
extern "C" int flash_attention_bhsd_launch(const void* raw, void* stream) {
  FlashArgs a;
  memcpy(&a, raw, sizeof a);
  if (a.d < 1 || a.d > 256 || a.heads < 1 || a.kv_heads < 1 ||
      a.heads % a.kv_heads || a.sq < 1 || a.sk < 1 || a.batch < 1 ||
      a.variant < 0 || a.variant > 2 || (a.variant == 1 && a.d > kRowsMaxD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = reinterpret_cast<const void*>(a.q);
  p.k = reinterpret_cast<const void*>(a.k);
  p.v = reinterpret_cast<const void*>(a.v);
  p.o = reinterpret_cast<void*>(a.o);
  p.h = static_cast<int>(a.heads);
  p.kvh = static_cast<int>(a.kv_heads);
  p.sq = static_cast<int>(a.sq);
  p.sk = static_cast<int>(a.sk);
  p.d = static_cast<int>(a.d);
  long long* st[12] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh, &p.k_ss,
                       &p.v_sb, &p.v_sh, &p.v_ss, &p.o_sb, &p.o_sh, &p.o_ss};
  // elements per 16 bytes: 8 of bf16, 4 of f32
  const long long per16 = a.variant == 0 ? 8 : 4;
  bool vec = a.d % per16 == 0 && aligned16(a.q) && aligned16(a.k) &&
             aligned16(a.v) && aligned16(a.o);
  for (int i = 0; i < 12; ++i) {
    *st[i] = a.strides[i];
    vec = vec && a.strides[i] % per16 == 0;
  }
  p.scale = static_cast<float>(a.scale);
  p.causal = a.causal ? 1 : 0;
  p.window = a.window > 0 ? static_cast<int>(a.window) : 0;
  p.softcap = a.softcap > 0.0 ? static_cast<float>(a.softcap) : 0.0f;
  p.inv_softcap = p.softcap > 0.0f ? 1.0f / p.softcap : 0.0f;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int batch = static_cast<int>(a.batch);
  if (a.variant == 0) {
    if (a.d <= 32) return static_cast<int>(launch_mma<32>(p, batch, s));
    if (a.d <= 64) return static_cast<int>(launch_mma<64>(p, batch, s));
    if (a.d <= 128) return static_cast<int>(launch_mma<128>(p, batch, s));
    return static_cast<int>(launch_mma<256>(p, batch, s));
  }
  if (a.variant == 1) {
    if (a.d <= 8) return static_cast<int>(launch_rows<8>(p, batch, s));
    if (a.d <= 16) return static_cast<int>(launch_rows<16>(p, batch, s));
    if (a.d <= 24) return static_cast<int>(launch_rows<24>(p, batch, s));
    return static_cast<int>(launch_rows<32>(p, batch, s));
  }
  if (a.d <= 64) return static_cast<int>(launch_tiled<64>(p, batch, s));
  if (a.d <= 128) return static_cast<int>(launch_tiled<128>(p, batch, s));
  return static_cast<int>(launch_tiled<256>(p, batch, s));
}
