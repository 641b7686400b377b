// Wire kernels of the CAFL-L round for Hopper (sm_90a).
//
// Each kernel sits behind a plain C entry point that launches it on the
// caller's stream and returns cudaGetLastError(); the Python wrappers in
// repro_torch/kernels/{quantize,wire}.py load this file's shared library
// with ctypes, allocate every output, and raise on a non-zero return.
//
// Bit-for-bit contract with repro_torch/kernels/ref.py (and so with
// repro/kernels/ref.py): the scale is absmax * inv with inv = f32(1/(L-1))
// passed from the host (a multiply, never a division); x / safe is the
// correctly rounded fp32 division (build WITHOUT --use_fast_math and never
// use __fdividef); the conversion to int rounds half to even, as rint
// does (cvt.rni), and gives 0 for a NaN. The reference runs under
// XLA, which flushes fp32 subnormals (inputs and results) to zeros of
// their sign. The kernels take that flush from the instructions, not from
// -ftz=true (the flags are shared with flash_attention.cu): the scale is
// mul.ftz.f32 (a subnormal absmax or product gives 0), and a subnormal x
// over any safe >= 2^-125 already rounds to the code 0 of its flushed
// value, so the dense quantizers flush their values only in a row whose
// scale lies in [2^-126, 2^-125) (a warp-uniform test a row); the top-k
// kernels rank values flushed by a mul.ftz by 1 (one instruction a
// value). (div.rn.ftz.f32 would flush for free, but it measured 5% slower
// than div.rn.f32 in the dense kernel on delta-like rows.) The absmax
// propagates NaN as jnp.max
// does (max.NaN.f32; fmaxf would drop it), and a NaN quotient takes code
// 0, the reference's cast; so a block holding a NaN gets scale NaN, and
// one holding +-inf scale inf and codes 0.
//
// What bounds them: all three functions are bound by bytes, with a
// handful of operations per value (selecting k of a row needs no more).
// The main path stages a client delta's leaves into one buffer of blocks
// (core/compression.py), so each kernel runs once per delta.
// The designs keep each pass to one read of the input, with the row's
// scale reduced or loaded once per row (never a second pass over device
// memory). Both quantizers give each block of a multiple of 128 values
// to one warp: float4 loads, an absmax of five warp shuffles (no shared
// memory, no barrier), codes (and the top-k mask) stored four to a
// 32-bit word, eight blocks to a CTA; other widths and unaligned inputs
// take one CTA per row, one thread per value. The top-k warp kernel
// selects in registers: the k-th largest magnitude's bit pattern is
// found MSB first, one warp-wide count a bit (at most 31, and it stops
// once exactly k magnitudes are at or above the candidate), and the ties
// at it are ranked in index order by ballots, so it spends tens of
// operations per value where the CTA kernel's pairwise rank spends
// `block` compares.
//
// The masked-sum fold is integer arithmetic, exact by construction, and
// bound by bytes too: each value is read once and each sum written once.
// masked_sum_u64 reads the cohort as the uint64 values it is (Hopper adds
// 64-bit integers natively); masked_sum_limbs takes the TPU's (hi, lo)
// uint32 limbs of the same values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 1024;   // one thread per value of a row
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// A subnormal -> a zero of its sign (XLA's flush), by a multiply by 1
// that flushes; NaN, inf and normal values pass unchanged.
__device__ __forceinline__ float flush(float v) {
  float r;
  asm("mul.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float4 flush4(float4 v) {
  return make_float4(flush(v.x), flush(v.y), flush(v.z), flush(v.w));
}

// max(a, b), NaN if either is NaN (jnp.max's rule; fmaxf drops a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// absmax * inv, flushed as XLA flushes: a subnormal absmax (a row of
// zeros and subnormals) or product gives 0
__device__ __forceinline__ float scale_of(float absmax, float inv) {
  float r;
  asm("mul.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(absmax), "f"(inv));
  return r;
}

// Max of |x| over the CTA's row, NaN if any is NaN. Every thread of the
// CTA must call it; threads past the row's end pass 0. Returns the same
// value to all.
__device__ __forceinline__ float row_absmax(float a, float* warp_max) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    a = max_nan(a, __shfl_xor_sync(kFullWarp, a, off));
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) warp_max[warp] = a;
  __syncthreads();
  const int n_warps = blockDim.x / kWarp;
  float m = 0.0f;
  for (int w = 0; w < n_warps; ++w) m = max_nan(m, warp_max[w]);
  return m;
}

// Below this scale (2^-125) a subnormal x / scale can round to a code of
// +-1 where the reference, which flushes x first, gives 0: such a row's
// values are flushed before quantize_value (needs_flush).
constexpr float kFlushBelow = 2.35098870164457501594e-38f;

__device__ __forceinline__ bool needs_flush(float scale) {
  return scale > 0.0f && scale < kFlushBelow;
}

// clip(rint(x / safe), -qmax, qmax) as int8; safe = scale, or 1 when the
// row is all zeros (scale == 0) or holds a NaN (scale NaN). The division
// is correctly rounded (a subnormal quotient rounds to code 0, as the
// reference's flushed one). The conversion rounds half to even, as rint
// does, saturates +-inf and turns a NaN quotient (x NaN, or +-inf over
// scale inf) into 0, the reference's cast; the clip is then on integers.
__device__ __forceinline__ int8_t quantize_value(float x, float scale,
                                                 float qmax) {
  const float safe = scale > 0.0f ? scale : 1.0f;
  const int m = static_cast<int>(qmax);
  return static_cast<int8_t>(min(max(__float2int_rn(x / safe), -m), m));
}

// Replaces repro/kernels/quantize.py::quantize_blocks (_quantize_kernel)
// at any block width and alignment: grid = n_blocks CTAs, blockDim =
// block rounded up to a warp. The main path's widths take the warp
// kernel below.
__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       int8_t* __restrict__ codes,
                                       float* __restrict__ scales, int block,
                                       float qmax, float inv) {
  __shared__ float warp_max[kMaxBlock / kWarp];
  const int64_t row = blockIdx.x;
  const int i = threadIdx.x;
  const bool live = i < block;
  const float v = live ? x[row * block + i] : 0.0f;
  const float absmax = row_absmax(fabsf(v), warp_max);
  const float scale = scale_of(absmax, inv);
  if (live) {
    codes[row * block + i] =
        quantize_value(needs_flush(scale) ? flush(v) : v, scale, qmax);
  }
  if (i == 0) scales[row] = scale;
}

// Replaces repro/kernels/quantize.py::quantize_blocks for blocks of a
// multiple of 128 values (the main path's 256): one warp per block, kVec
// float4 per lane (block = 128 * kVec). Lane l loads float4 l + 32 j of
// its row, so each warp-wide load covers 512 consecutive bytes; the
// absmax is five xor shuffles (NaN-propagating); each lane packs its
// float4's four codes into one 32-bit word, so each warp-wide store
// covers 128 consecutive bytes. A row's early exit is uniform over its
// warp, so the shuffles always see all 32 lanes.
constexpr int kQuantWarps = 8;   // blocks per CTA

__device__ __forceinline__ uint32_t quantize4(float4 v, float scale,
                                              float qmax) {
  const uint32_t b0 = static_cast<uint8_t>(quantize_value(v.x, scale, qmax));
  const uint32_t b1 = static_cast<uint8_t>(quantize_value(v.y, scale, qmax));
  const uint32_t b2 = static_cast<uint8_t>(quantize_value(v.z, scale, qmax));
  const uint32_t b3 = static_cast<uint8_t>(quantize_value(v.w, scale, qmax));
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

__device__ __forceinline__ float absmax4(float4 v) {
  return max_nan(max_nan(fabsf(v.x), fabsf(v.y)),
                 max_nan(fabsf(v.z), fabsf(v.w)));
}

template <int kVec>
__global__ void __launch_bounds__(kQuantWarps * kWarp)
quantize_blocks_warp_kernel(const float4* __restrict__ x,
                            uint32_t* __restrict__ codes,
                            float* __restrict__ scales, int n_blocks,
                            float qmax, float inv) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kQuantWarps +
                      threadIdx.x / kWarp;
  if (row >= n_blocks) return;
  const float4* xr = x + row * (kWarp * kVec);
  float4 v[kVec];
  float a = 0.0f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    v[j] = xr[lane + kWarp * j];
    a = max_nan(a, absmax4(v[j]));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    a = max_nan(a, __shfl_xor_sync(kFullWarp, a, off));
  }
  const float scale = scale_of(a, inv);
  if (needs_flush(scale)) {  // warp-uniform
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = flush4(v[j]);
  }
  uint32_t* cr = codes + row * (kWarp * kVec);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    cr[lane + kWarp * j] = quantize4(v[j], scale, qmax);
  }
  if (lane == 0) scales[row] = scale;
}

template <int kVec>
void launch_quantize_warp(const void* x, void* codes, void* scales,
                          int n_blocks, float qmax, float inv,
                          cudaStream_t s) {
  const int grid = (n_blocks + kQuantWarps - 1) / kQuantWarps;
  quantize_blocks_warp_kernel<kVec><<<grid, kQuantWarps * kWarp, 0, s>>>(
      static_cast<const float4*>(x), static_cast<uint32_t*>(codes),
      static_cast<float*>(scales), n_blocks, qmax, inv);
}

// the warp kernel's launcher by float4s per lane (block / 128 - 1)
using QuantizeWarpFn = void (*)(const void*, void*, void*, int, float, float,
                                cudaStream_t);
constexpr QuantizeWarpFn kQuantizeWarp[kMaxBlock / 128] = {
    launch_quantize_warp<1>, launch_quantize_warp<2>, launch_quantize_warp<3>,
    launch_quantize_warp<4>, launch_quantize_warp<5>, launch_quantize_warp<6>,
    launch_quantize_warp<7>, launch_quantize_warp<8>};

// Replaces repro/kernels/quantize.py::dequantize_blocks (_dequantize_kernel):
// code * scale[row] (code 0 -> exactly 0.0). The main path decodes a
// whole client delta in one launch (every leaf's blocks staged into one
// buffer), so the grid is sized to the buffer, not to a row: each thread
// loads 16 codes of one row with one 16-byte load and reads the row's
// scale once for them. The warp then trades words by shuffles so that
// each of its four float4 stores covers 512 consecutive bytes.
constexpr int kDequantThreads = 256;
constexpr int kCodesPerThread = 16;

__device__ __forceinline__ float4 decode4(uint32_t word, float scale) {
  float x[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int8_t c = static_cast<int8_t>((word >> (8 * b)) & 0xffu);
    x[b] = static_cast<float>(c) * scale;
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

__global__ void dequantize_blocks_vec16_kernel(
    const int4* __restrict__ codes, const float* __restrict__ scales,
    float4* __restrict__ out, int groups_per_row, int64_t n_groups) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDequantThreads +
                    threadIdx.x;  // this thread's 16 codes
  const int lane = threadIdx.x % kWarp;
  const int64_t first = i - lane;  // the warp's first group
  int4 packed = make_int4(0, 0, 0, 0);
  float scale = 0.0f;
  if (i < n_groups) {
    packed = codes[i];
    scale = scales[i / groups_per_row];
  }
  // store w: lane l writes float4 (first * 4 + 32 w + l), the codes of
  // word l % 4 of group first + 8 w + l / 4
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int src = 8 * w + lane / 4;
    const int x = __shfl_sync(0xffffffffu, packed.x, src);
    const int y = __shfl_sync(0xffffffffu, packed.y, src);
    const int z = __shfl_sync(0xffffffffu, packed.z, src);
    const int v = __shfl_sync(0xffffffffu, packed.w, src);
    const float sc = __shfl_sync(0xffffffffu, scale, src);
    const int k = lane % 4;
    const uint32_t word =
        static_cast<uint32_t>(k == 0 ? x : (k == 1 ? y : (k == 2 ? z : v)));
    if (first + src < n_groups) {
      out[first * 4 + 32 * w + lane] = decode4(word, sc);
    }
  }
}

// Any block width (one CTA per row, one thread per value): the path for
// rows that are not a multiple of 16 codes.
__global__ void dequantize_blocks_kernel(const int8_t* __restrict__ codes,
                                         const float* __restrict__ scales,
                                         float* __restrict__ out, int block) {
  const int64_t row = blockIdx.x;
  const int i = threadIdx.x;
  const float scale = scales[row];
  if (i < block) {
    out[row * block + i] = static_cast<float>(codes[row * block + i]) * scale;
  }
}

// Replaces repro/kernels/wire.py::quantize_topk_blocks (_quantize_topk_kernel)
// at any block width and alignment: the CTA shape of quantize_blocks_kernel.
// |x| of the row goes to shared memory and each thread counts its own rank
// over the row:
//   rank_i = #{j: a_j > a_i} + #{j < i: a_j == a_i},  keep = rank < k.
// Every thread reads the same a_j in the same step (a shared-memory
// broadcast, no bank conflicts). IEEE compares give the reference's NaN
// rule for free: a NaN is never ahead of another value and has rank 0.
// The main path's widths take the warp kernel below.
__global__ void quantize_topk_blocks_kernel(const float* __restrict__ x,
                                            int8_t* __restrict__ codes,
                                            float* __restrict__ scales,
                                            int8_t* __restrict__ mask,
                                            int block, float qmax, float inv,
                                            int k) {
  __shared__ float warp_max[kMaxBlock / kWarp];
  __shared__ float absx[kMaxBlock];
  const int64_t row = blockIdx.x;
  const int i = threadIdx.x;
  const bool live = i < block;
  const float v = live ? flush(x[row * block + i]) : 0.0f;
  const float a = fabsf(v);
  if (live) absx[i] = a;
  // row_absmax's __syncthreads also publishes absx
  const float absmax = row_absmax(a, warp_max);
  const float scale = scale_of(absmax, inv);
  if (live) {
    int rank = 0;
    for (int j = 0; j < block; ++j) {
      const float aj = absx[j];
      rank += (aj > a) || (aj == a && j < i);
    }
    const bool keep = rank < k;
    codes[row * block + i] = keep ? quantize_value(v, scale, qmax) : 0;
    mask[row * block + i] = keep ? 1 : 0;
  }
  if (i == 0) scales[row] = scale;
}

// Replaces repro/kernels/wire.py::quantize_topk_blocks for blocks of a
// multiple of 128 values (the main path's 256): one warp per block, the
// loads, absmax and scale of quantize_blocks_warp_kernel, then an exact
// select of the k largest magnitudes in registers. The key of a value is
// the bit pattern of its flushed |x| as an int, whose order is the float
// order (+inf included); a NaN's key is -1, so it is never counted ahead
// of another value, and it is kept. T, the largest key with
// #{key >= T} >= k (0 when fewer than k values are not NaN), is built MSB
// first over the bits under the block's largest key, one warp-wide count
// (__reduce_add_sync) per bit, until exactly k keys are >= T. A value
// with key > T is kept. Of those with key == T, all are kept when
// #{key >= T} <= k, else the first k - #{key > T} in index order: lane
// l's float4 j holds values 128 j + 4 l .. 128 j + 4 l + 3, so a tie's
// place is the ties of earlier float4 slots, plus those of lower lanes in
// its slot (a ballot a component), plus those before it in its float4.
// That is the reference's rank < k with ties to the lower index, bit for
// bit.
template <int kVec>
__global__ void __launch_bounds__(kQuantWarps * kWarp)
quantize_topk_blocks_warp_kernel(const float4* __restrict__ x,
                                 uint32_t* __restrict__ codes,
                                 float* __restrict__ scales,
                                 uint32_t* __restrict__ mask, int n_blocks,
                                 float qmax, float inv, int k) {
  constexpr int kVals = 4 * kVec;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kQuantWarps +
                      threadIdx.x / kWarp;
  if (row >= n_blocks) return;
  const float4* xr = x + row * (kWarp * kVec);
  float v[kVals];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float4 f = flush4(xr[lane + kWarp * j]);
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
  float a = 0.0f;
  int key[kVals];
  int top = -1;      // this lane's largest key
  int valid = 0;     // this lane's values that are not NaN
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    a = max_nan(a, fabsf(v[i]));
    key[i] = isnan(v[i]) ? -1 : __float_as_int(fabsf(v[i]));
    top = max(top, key[i]);
    valid += key[i] >= 0;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    a = max_nan(a, __shfl_xor_sync(kFullWarp, a, off));
  }
  const float scale = scale_of(a, inv);
  top = __reduce_max_sync(kFullWarp, top);
  int t = 0;                                       // T
  int at_t = __reduce_add_sync(kFullWarp, valid);  // #{key >= T}
  // Once exactly k keys are >= T, they are the k kept and the search
  // ends (for delta-like rows at the first bit where the k-th and
  // (k+1)-th largest magnitudes differ); at_t > k also means top >= 0.
  for (int b = 31 - __clz(top); b >= 0 && at_t > k; --b) {
    const int cand = t | (1 << b);
    // #{key < cand} from the sign of key - cand (no overflow: keys are
    // in [-1, 0x7f800000] and cand in [1, 0x7fffffff])
    int below = 0;
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      below += static_cast<unsigned>(key[i] - cand) >> 31;
    }
    const int n = kWarp * kVals - __reduce_add_sync(kFullWarp, below);
    if (n >= k) {
      t = cand;
      at_t = n;
    }
  }
  // ties at T ration only when #{key >= T} > k (warp-uniform)
  const bool ration = at_t > k;
  int need = 0;                                    // ties to keep
  if (ration) {
    int above = 0;
#pragma unroll
    for (int i = 0; i < kVals; ++i) above += key[i] > t;
    need = k - __reduce_add_sync(kFullWarp, above);
  }
  const unsigned lower_lanes = (1u << lane) - 1u;
  int before = 0;      // ties in the row's earlier float4 slots
  uint32_t* cr = codes + row * (kWarp * kVec);
  uint32_t* mr = mask + row * (kWarp * kVec);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    int place = before;  // ties ahead of this lane's first value of slot j
    if (ration) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned ties = __ballot_sync(kFullWarp, key[4 * j + c] == t);
        place += __popc(ties & lower_lanes);
        before += __popc(ties);
      }
    }
    uint32_t cw = 0, mw = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * j + c;
      const bool tie = key[i] == t;
      const bool keep = key[i] > t || key[i] < 0 ||
                        (tie && (!ration || place < need));
      place += tie;
      if (keep) {
        cw |= static_cast<uint32_t>(static_cast<uint8_t>(
                  quantize_value(v[i], scale, qmax))) << (8 * c);
        mw |= 1u << (8 * c);
      }
    }
    cr[lane + kWarp * j] = cw;
    mr[lane + kWarp * j] = mw;
  }
  if (lane == 0) scales[row] = scale;
}

template <int kVec>
void launch_topk_warp(const void* x, void* codes, void* scales, void* mask,
                      int n_blocks, float qmax, float inv, int k,
                      cudaStream_t s) {
  const int grid = (n_blocks + kQuantWarps - 1) / kQuantWarps;
  quantize_topk_blocks_warp_kernel<kVec><<<grid, kQuantWarps * kWarp, 0, s>>>(
      static_cast<const float4*>(x), static_cast<uint32_t*>(codes),
      static_cast<float*>(scales), static_cast<uint32_t*>(mask), n_blocks,
      qmax, inv, k);
}

// the top-k warp kernel's launcher by float4s per lane (block / 128 - 1)
using TopkWarpFn = void (*)(const void*, void*, void*, void*, int, float,
                            float, int, cudaStream_t);
constexpr TopkWarpFn kTopkWarp[kMaxBlock / 128] = {
    launch_topk_warp<1>, launch_topk_warp<2>, launch_topk_warp<3>,
    launch_topk_warp<4>, launch_topk_warp<5>, launch_topk_warp<6>,
    launch_topk_warp<7>, launch_topk_warp<8>};

// Replaces repro/kernels/wire.py::masked_sum_limbs (_masked_sum_kernel).
// hi, lo: (rows, n) uint32 limbs of uint64 values. One thread owns one
// column: it walks the rows, adds ((uint64)hi << 32) | lo in uint64 (which
// wraps mod 2^64, so no radix-2^16 digits or carry ripple are needed on
// this card) and writes the sum's two limbs. Consecutive threads read
// consecutive columns, so every row read is coalesced; a ragged n is a
// bounds check, with no padding to a tile.
__global__ void masked_sum_limbs_kernel(const uint32_t* __restrict__ hi,
                                        const uint32_t* __restrict__ lo,
                                        uint32_t* __restrict__ hi_out,
                                        uint32_t* __restrict__ lo_out,
                                        int rows, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  uint64_t acc = 0;
  for (int r = 0; r < rows; ++r) {
    const int64_t at = r * n + j;
    acc += (static_cast<uint64_t>(hi[at]) << 32) | lo[at];
  }
  hi_out[j] = static_cast<uint32_t>(acc >> 32);
  lo_out[j] = static_cast<uint32_t>(acc);
}

// Replaces repro/kernels/wire.py::masked_sum_limbs on the uint64 values
// themselves (the TPU carried them as limbs only for want of 64-bit
// adds). vals: (rows, n) uint64, row-major; out: (n,) sums mod 2^64.
// The vec2 kernel gives each thread two adjacent columns, one 16-byte
// load per row (512 consecutive bytes per warp and row). It issues the
// loads of up to kSumRowsAhead rows before their adds, so a cohort of 6
// has all six loads in flight at once (a runtime-count loop unrolled by
// the compiler would leave 6 < 8 rows to its one-at-a-time remainder).
// Every value is read once and every sum written once, so loads and the
// store are marked streaming (evict first) and leave L2 to others.
// It needs every row start on 16 bytes (an even n, aligned bases); the
// scalar kernel, one column a thread, takes an odd n or an unaligned
// base.
constexpr int kSumRowsAhead = 8;

__global__ void masked_sum_u64_vec2_kernel(const ulonglong2* __restrict__ vals,
                                           ulonglong2* __restrict__ out,
                                           int rows, int64_t pairs) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= pairs) return;
  unsigned long long a = 0, b = 0;
  for (int r0 = 0; r0 < rows; r0 += kSumRowsAhead) {
    ulonglong2 v[kSumRowsAhead];
#pragma unroll
    for (int i = 0; i < kSumRowsAhead; ++i) {
      v[i] = r0 + i < rows ? __ldcs(vals + (r0 + i) * pairs + j)
                           : make_ulonglong2(0, 0);
    }
#pragma unroll
    for (int i = 0; i < kSumRowsAhead; ++i) {
      a += v[i].x;
      b += v[i].y;
    }
  }
  __stcs(out + j, make_ulonglong2(a, b));
}

__global__ void masked_sum_u64_scalar_kernel(
    const unsigned long long* __restrict__ vals,
    unsigned long long* __restrict__ out, int rows, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  unsigned long long acc = 0;
  for (int r = 0; r < rows; ++r) acc += vals[r * n + j];
  out[j] = acc;
}

constexpr int kSumThreads = 256;

inline int threads_for(int block) {
  return (block + kWarp - 1) / kWarp * kWarp;
}

}  // namespace

extern "C" {

int quantize_blocks_launch(const void* x, void* codes, void* scales,
                           int n_blocks, int block, int bits, float inv,
                           void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool warp = block % 128 == 0 && block <= kMaxBlock &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  if (warp) {
    kQuantizeWarp[block / 128 - 1](x, codes, scales, n_blocks, qmax, inv, s);
  } else {
    quantize_blocks_kernel<<<n_blocks, threads_for(block), 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(codes),
        static_cast<float*>(scales), block, qmax, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

int dequantize_blocks_launch(const void* codes, const void* scales, void* out,
                             int n_blocks, int block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % kCodesPerThread == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int groups_per_row = block / kCodesPerThread;
    const int64_t n_groups = static_cast<int64_t>(n_blocks) * groups_per_row;
    const int64_t grid = (n_groups + kDequantThreads - 1) / kDequantThreads;
    dequantize_blocks_vec16_kernel<<<static_cast<unsigned int>(grid),
                                     kDequantThreads, 0, s>>>(
        static_cast<const int4*>(codes), static_cast<const float*>(scales),
        static_cast<float4*>(out), groups_per_row, n_groups);
  } else {
    dequantize_blocks_kernel<<<n_blocks, threads_for(block), 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        static_cast<float*>(out), block);
  }
  return static_cast<int>(cudaGetLastError());
}

// warp != 0 asks for the warp-per-block kernel (the wrapper picks it and
// counts it); a row it cannot take is refused with cudaErrorInvalidValue.
int quantize_topk_blocks_launch(const void* x, void* codes, void* scales,
                                void* mask, int n_blocks, int block, int bits,
                                float inv, int k, int warp, void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp) {
    if (block % 128 != 0 || block > kMaxBlock ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(codes) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(mask) % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    kTopkWarp[block / 128 - 1](x, codes, scales, mask, n_blocks, qmax, inv, k,
                               s);
  } else {
    quantize_topk_blocks_kernel<<<n_blocks, threads_for(block), 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(codes),
        static_cast<float*>(scales), static_cast<int8_t*>(mask), block, qmax,
        inv, k);
  }
  return static_cast<int>(cudaGetLastError());
}

int masked_sum_limbs_launch(const void* hi, const void* lo, void* hi_out,
                            void* lo_out, int rows, int64_t n, void* stream) {
  const int64_t grid = (n + kSumThreads - 1) / kSumThreads;
  masked_sum_limbs_kernel<<<static_cast<unsigned int>(grid), kSumThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<uint32_t*>(hi_out), static_cast<uint32_t*>(lo_out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

int masked_sum_u64_launch(const void* vals, void* out, int rows, int64_t n,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int64_t pairs = n / 2;
    const int64_t grid = (pairs + kSumThreads - 1) / kSumThreads;
    masked_sum_u64_vec2_kernel<<<static_cast<unsigned int>(grid),
                                 kSumThreads, 0, s>>>(
        static_cast<const ulonglong2*>(vals), static_cast<ulonglong2*>(out),
        rows, pairs);
  } else {
    const int64_t grid = (n + kSumThreads - 1) / kSumThreads;
    masked_sum_u64_scalar_kernel<<<static_cast<unsigned int>(grid),
                                   kSumThreads, 0, s>>>(
        static_cast<const unsigned long long*>(vals),
        static_cast<unsigned long long*>(out), rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
