// Ragged paged-attention decode for Hopper (sm_90a): split-KV flash decoding.
//
// Replaces the two Pallas kernels of fms_fsdp_tpu/ops/paged_attention.py:
//   - _paged_decode_kernel (v1, one pool page per grid cell, pools in the
//     compute dtype);
//   - _paged_decode_kernel_v2 (block_kv // page_size pages per cell, int8 or
//     float8_e4m3fn pools dequantised on chip from fp32 row scales).
// One templated kernel pair covers both contracts: storage bf16 | fp16 |
// fp32 | int8 | e4m3, with optional fp32 row scales. Head dim 128 (every
// Llama variant of the repo); group = Nq / Nkv up to 8.
//
// Contract (paged_attention_reference): q (B, Nq, H); pages (P, ps, Nkv, H);
// page_table (B, maxp) int32; seq_lens (B,) int32. Row b's one query sits at
// position seq_lens[b] and attends to cache positions <= seq_lens[b] through
// its page-table row. Output (B, Nq*H) in q's dtype. A row that attends
// nothing (l == 0) writes zeros, not NaN.
//
// What bounds it: the bytes of K/V it reads. Per (row, kv head) it does
// 4 * group * H flops for each key whose K and V rows are 2 * H storage
// elements: about group flops per byte, far below the ~295 the H100 needs
// before compute is the limit. So the design is about keeping enough bytes
// in flight from enough SMs:
//   - split-KV: the grid is (key split, kv head, row). A split is a fixed
//     run of split_keys keys (a multiple of the page size and of the 64-key
//     stage), planned by the wrapper from shapes alone (decode_splits in
//     ops/paged_attention.py), never from seq_lens, so the grid needs no
//     host sync and stays fixed for a CUDA graph. A split that starts past
//     its row's length exits at once. Each split writes fp32 partials (m, l
//     and the unnormalised o of each query head of the group) to scratch;
//     a second small kernel, launched from the same entry point, merges a
//     row's live splits with the log-sum-exp rule and writes o, one block
//     per query head with the splits' weights computed in parallel. No
//     atomics: the result is deterministic;
//   - the block's K/V pages are staged in their storage type with 16-byte
//     cp.async copies into a ring of 3 stages of 64 keys, two stages ahead
//     of the compute; the block reads its own page-table row; rows are
//     padded by 16 bytes so ldmatrix and the byte loads are free of bank
//     conflicts. Nothing is widened in shared memory;
//   - 16-bit compute runs on the tensor cores through mma.sync m16n8k16,
//     keys on M and the group's query heads on N (zero columns for G < 8):
//     S^T = K.Q^T, then O^T += V^T.P^T with V^T read through ldmatrix.trans.
//     Each of the four warps owns 16 keys of a stage and keeps its own
//     online softmax; the four are merged in shared memory at the end of the
//     split. int8 / e4m3 elements are dequantised in registers as
//     round_to<compute>(x * scale) right before the product;
//   - fp32 compute (fp32 pools, or quantized pools read in fp32) keeps
//     scalar FMA with the same staging: TF32 would change the numbers.
// Numerics as the TPU kernels: the fp32 online softmax runs in base 2, with
// scale * log2(e) folded into q and q rounded back to its dtype; p is
// rounded to the compute dtype before the PV product; a quantized row is
// dequantised as (x * scale) -> compute dtype before its product. The only
// change in summation order against one block per row is the merge of the
// warps and splits, in fp32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHead = 128;       // head dim
constexpr int kThreads = 128;    // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageKeys = 64;   // keys per stage, 16 per warp
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kMaxGroup = 8;     // query heads per kv head (the mma N)

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kE4M3 = 4 };

// one storage byte of a quantized pool as fp32
template <typename KT> __device__ __forceinline__ float byte_to_float(uint32_t b);
template <> __device__ __forceinline__ float byte_to_float<int8_t>(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
}
template <> __device__ __forceinline__ float byte_to_float<__nv_fp8_e4m3>(uint32_t b) {
  __nv_fp8_e4m3 x;
  x.__x = static_cast<__nv_fp8_storage_t>(b & 0xffu);
  return static_cast<float>(x);
}

// rounding of an fp32 value to the compute dtype, kept in fp32
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

// cp.async copies; a copy with valid == false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// The shared-memory layout of one kernel instance.
template <typename QT, typename KT, bool kQuant>
struct Layout {
  static constexpr bool kMma = !std::is_same<QT, float>::value;
  static constexpr int kRowBytes = kHead * static_cast<int>(sizeof(KT)) + 16;  // padded
  static constexpr int kChunksPerRow = kHead * static_cast<int>(sizeof(KT)) / 16;
  static constexpr int kLoadIters = kStageKeys * kChunksPerRow / kThreads;
  static constexpr int kStageBytes = 2 * kStageKeys * kRowBytes;  // K rows, then V rows
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kScales = kQuant ? kStages * 2 * kStageKeys * 4 : 0;
  // q: 16-bit rows padded to 136 elements (ldmatrix), fp32 rows to 132
  static constexpr int kLdq = kMma ? kHead + 8 : kHead + 4;
  static constexpr int kQBytes = kMaxGroup * kLdq * static_cast<int>(sizeof(QT));
  static constexpr int kPBytes = kWarps * 16 * kMaxGroup * 4;  // per-warp P staging
  static constexpr int kStatBytes = 2 * kWarps * kMaxGroup * 4;
  static constexpr int kOBytes = kWarps * kMaxGroup * kHead * 4;  // aliases the ring
  static constexpr int kScalesOff = kRing;
  static constexpr int kQOff = kScalesOff + kScales;
  static constexpr int kPOff = kQOff + kQBytes;
  static constexpr int kStatOff = kPOff + kPBytes;
  static constexpr int kBytes = kStatOff + kStatBytes;
  static_assert(kOBytes <= kRing, "the warp merge reuses the ring");
  static_assert(kLoadIters * kThreads == kStageKeys * kChunksPerRow, "whole chunks");
};

// grid (splits, Nkv, B): one block per (key split, kv head, row)
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    float* __restrict__ part_o, float* __restrict__ part_ml, int nkv, int page_size,
    int max_pages, int group, int split_keys, float q_scale) {
  using L = Layout<QT, KT, kQuant>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = group;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int pos = seq_lens[b];
  const int capacity = max_pages * page_size;
  const int n_keys = pos < 0 ? 0 : min(pos + 1, capacity);
  const int k0 = split * split_keys;
  if (k0 >= n_keys) return;  // the combine reads only the live splits
  const int k_end = min(k0 + split_keys, n_keys);
  const int n_st = (k_end - k0 + kStageKeys - 1) / kStageKeys;
  const int* table_row = page_table + static_cast<int64_t>(b) * max_pages;

  unsigned char* ring = smem;
  float* scales = reinterpret_cast<float*>(smem + L::kScalesOff);
  QT* q_s = reinterpret_cast<QT*>(smem + L::kQOff);
  unsigned char* p_w = smem + L::kPOff + warp * 16 * kMaxGroup * 4;
  float* m_s = reinterpret_cast<float*>(smem + L::kStatOff);
  float* l_s = m_s + kWarps * kMaxGroup;

  // stage `st` of the split into ring slot `slot`; keys >= k_end read zeros
  auto load_stage = [&](int st, int slot) {
    unsigned char* kb = ring + slot * L::kStageBytes;
    unsigned char* vb = kb + kStageKeys * L::kRowBytes;
    const int key0 = k0 + st * kStageKeys;
#pragma unroll
    for (int j = 0; j < L::kLoadIters; ++j) {
      const int c = tid + j * kThreads;
      const int r = c / L::kChunksPerRow;
      const int col = (c % L::kChunksPerRow) * 16;
      const int key = key0 + r;
      const bool valid = key < k_end;
      int64_t row = 0;
      if (valid) {
        const int page = __ldg(table_row + key / page_size);
        row = (static_cast<int64_t>(page) * page_size + key % page_size) * nkv + kvh;
      }
      const int64_t off = row * kHead * static_cast<int64_t>(sizeof(KT)) + col;
      cp_async16(kb + r * L::kRowBytes + col,
                 reinterpret_cast<const unsigned char*>(k_pages) + off, valid);
      cp_async16(vb + r * L::kRowBytes + col,
                 reinterpret_cast<const unsigned char*>(v_pages) + off, valid);
    }
    if (kQuant) {
      const int r = tid & (kStageKeys - 1);
      const int key = key0 + r;
      const bool valid = key < k_end;
      int64_t row = 0;
      if (valid) {
        const int page = __ldg(table_row + key / page_size);
        row = (static_cast<int64_t>(page) * page_size + key % page_size) * nkv + kvh;
      }
      const float* src = tid < kStageKeys ? k_scales : v_scales;
      cp_async4(scales + (slot * 2 + tid / kStageKeys) * kStageKeys + r, src + row, valid);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) load_stage(st, st);
    cp_async_commit();
  }

  // q scaled by scale * log2(e) and rounded back to its dtype; rows past
  // the group are zero
  const int64_t q_off =
      (static_cast<int64_t>(b) * nkv * G + static_cast<int64_t>(kvh) * G) * kHead;
  for (int i = tid; i < kMaxGroup * kHead; i += kThreads) {
    const int g = i / kHead;
    const int d = i - g * kHead;
    const float x = g < G ? round_to<QT>(to_f(q[q_off + g * kHead + d]) * q_scale) : 0.f;
    q_s[g * L::kLdq + d] = from_f<QT>(x);
  }
  __syncthreads();

  const int g = lane >> 2;  // mma fragment coordinates
  const int t = lane & 3;

  if constexpr (L::kMma) {
    // ---------------- tensor-core path (16-bit compute) ----------------
    // Q^T as B fragments, for all 8 k steps of the 128-wide head
    uint32_t qf[kHead / 16][2];
#pragma unroll
    for (int kk2 = 0; kk2 < kHead / 32; ++kk2) {
      uint32_t r[4];
      ldsm_x4(r, q_s + (lane & 7) * L::kLdq + kk2 * 32 + (lane >> 3) * 8);
      qf[2 * kk2][0] = r[0];
      qf[2 * kk2][1] = r[1];
      qf[2 * kk2 + 1][0] = r[2];
      qf[2 * kk2 + 1][1] = r[3];
    }
    // O^T (128 x 8) in the accumulator layout: acc[mt] holds head-dim rows
    // mt*16 + g and + 8, heads 2t and 2t + 1
    float acc[kHead / 16][4];
#pragma unroll
    for (int mt = 0; mt < kHead / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // heads 2t, 2t + 1 (base 2)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
    uint16_t* ps = reinterpret_cast<uint16_t*>(p_w);  // P^T (16 keys x 8 heads)

    for (int it = 0; it < n_st; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < n_st) load_stage(it + kStages - 1, (it + kStages - 1) % kStages);
      cp_async_commit();

      const int slot = it % kStages;
      const int wk0 = k0 + it * kStageKeys + warp * 16;  // the warp's first key
      if (wk0 >= k_end) continue;                        // warp-uniform
      const unsigned char* kb = ring + slot * L::kStageBytes + warp * 16 * L::kRowBytes;
      const unsigned char* vb = kb + kStageKeys * L::kRowBytes;
      const float* ksc = scales + (slot * 2) * kStageKeys + warp * 16;
      const float* vsc = ksc + kStageKeys;

      // S^T = K . Q^T: 16 keys x 8 heads
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const float sk_lo = kQuant ? ksc[g] : 1.f;
      const float sk_hi = kQuant ? ksc[g + 8] : 1.f;
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        uint32_t a[4];
        if constexpr (!kQuant) {
          ldsm_x4(a, kb + (lane & 15) * L::kRowBytes + (kk * 16 + (lane >> 4) * 8) * 2);
        } else {
          const unsigned char* r0 = kb + g * L::kRowBytes + kk * 16 + 2 * t;
          const unsigned char* r1 = r0 + 8 * L::kRowBytes;
          const uint32_t x0 = *reinterpret_cast<const uint16_t*>(r0);
          const uint32_t x1 = *reinterpret_cast<const uint16_t*>(r1);
          const uint32_t x2 = *reinterpret_cast<const uint16_t*>(r0 + 8);
          const uint32_t x3 = *reinterpret_cast<const uint16_t*>(r1 + 8);
          a[0] = pack2<QT>(byte_to_float<KT>(x0) * sk_lo, byte_to_float<KT>(x0 >> 8) * sk_lo);
          a[1] = pack2<QT>(byte_to_float<KT>(x1) * sk_hi, byte_to_float<KT>(x1 >> 8) * sk_hi);
          a[2] = pack2<QT>(byte_to_float<KT>(x2) * sk_lo, byte_to_float<KT>(x2 >> 8) * sk_lo);
          a[3] = pack2<QT>(byte_to_float<KT>(x3) * sk_hi, byte_to_float<KT>(x3 >> 8) * sk_hi);
        }
        mma16816<QT>(s, a, qf[kk][0], qf[kk][1]);
      }
      if (wk0 + g >= k_end) s[0] = s[1] = -INFINITY;
      if (wk0 + g + 8 >= k_end) s[2] = s[3] = -INFINITY;

      // online softmax per head over the warp's 16 keys (lanes of one t)
      float mx0 = fmaxf(s[0], s[2]);
      float mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0);  // finite: key wk0 is live
      const float mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0);  // first stage: exp2(-inf) = 0
      const float al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      const float p0 = exp2f(s[0] - mn0);  // masked: exp2(-inf) = 0
      const float p1 = exp2f(s[1] - mn1);
      const float p2 = exp2f(s[2] - mn0);
      const float p3 = exp2f(s[3] - mn1);
      l0 = l0 * al0 + p0 + p2;
      l1 = l1 * al1 + p1 + p3;
#pragma unroll
      for (int mt = 0; mt < kHead / 16; ++mt) {
        acc[mt][0] *= al0;
        acc[mt][1] *= al1;
        acc[mt][2] *= al0;
        acc[mt][3] *= al1;
      }
      // P^T rounded to the compute dtype, through the warp's scratch into
      // the B-fragment layout (keys 2t, 2t+1 and 2t+8, 2t+9 of head g)
      *reinterpret_cast<uint32_t*>(ps + g * kMaxGroup + 2 * t) = pack2<QT>(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (g + 8) * kMaxGroup + 2 * t) = pack2<QT>(p2, p3);
      __syncwarp();
      const uint32_t b0 = static_cast<uint32_t>(ps[(2 * t) * kMaxGroup + g]) |
                          (static_cast<uint32_t>(ps[(2 * t + 1) * kMaxGroup + g]) << 16);
      const uint32_t b1 = static_cast<uint32_t>(ps[(2 * t + 8) * kMaxGroup + g]) |
                          (static_cast<uint32_t>(ps[(2 * t + 9) * kMaxGroup + g]) << 16);
      __syncwarp();  // the scratch is rewritten next stage

      // O^T += V^T . P^T
      float sv[4] = {1.f, 1.f, 1.f, 1.f};
      if (kQuant) {
        sv[0] = vsc[2 * t];
        sv[1] = vsc[2 * t + 1];
        sv[2] = vsc[2 * t + 8];
        sv[3] = vsc[2 * t + 9];
      }
#pragma unroll
      for (int mt = 0; mt < kHead / 16; ++mt) {
        uint32_t a[4];
        if constexpr (!kQuant) {
          ldsm_x4_trans(a, vb + ((lane & 7) + ((lane >> 4) << 3)) * L::kRowBytes +
                               (mt * 16 + ((lane >> 3) & 1) * 8) * 2);
        } else {
          // a0: head-dim row mt*16+g, keys 2t, 2t+1; a1: row +8; a2, a3: keys +8
          const unsigned char* c0 = vb + (2 * t) * L::kRowBytes + mt * 16 + g;
          const unsigned char* c1 = c0 + L::kRowBytes;
          const unsigned char* c8 = c0 + 8 * L::kRowBytes;
          const unsigned char* c9 = c8 + L::kRowBytes;
          a[0] = pack2<QT>(byte_to_float<KT>(c0[0]) * sv[0], byte_to_float<KT>(c1[0]) * sv[1]);
          a[1] = pack2<QT>(byte_to_float<KT>(c0[8]) * sv[0], byte_to_float<KT>(c1[8]) * sv[1]);
          a[2] = pack2<QT>(byte_to_float<KT>(c8[0]) * sv[2], byte_to_float<KT>(c9[0]) * sv[3]);
          a[3] = pack2<QT>(byte_to_float<KT>(c8[8]) * sv[2], byte_to_float<KT>(c9[8]) * sv[3]);
        }
        mma16816<QT>(acc[mt], a, b0, b1);
      }
    }

#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is reused for the warps' outputs
    float* o_s = reinterpret_cast<float*>(ring);
    if (g == 0) {
      m_s[warp * kMaxGroup + 2 * t] = m0;
      m_s[warp * kMaxGroup + 2 * t + 1] = m1;
      l_s[warp * kMaxGroup + 2 * t] = l0;
      l_s[warp * kMaxGroup + 2 * t + 1] = l1;
    }
    float* ow = o_s + warp * kMaxGroup * kHead;
#pragma unroll
    for (int mt = 0; mt < kHead / 16; ++mt) {
      const int d = mt * 16 + g;
      ow[(2 * t) * kHead + d] = acc[mt][0];
      ow[(2 * t + 1) * kHead + d] = acc[mt][1];
      ow[(2 * t) * kHead + d + 8] = acc[mt][2];
      ow[(2 * t + 1) * kHead + d + 8] = acc[mt][3];
    }
  } else {
    // ---------------- scalar path (fp32 compute) ----------------
    // scores: lane owns key (lane & 15) and heads 4 * (lane >> 4) .. + 3;
    // P.V: lane owns head-dim columns 4 * lane .. + 3 of every head
    const int key = lane & 15;
    const int hq = lane >> 4;
    const float* qf = reinterpret_cast<const float*>(q_s);
    float* pf = reinterpret_cast<float*>(p_w);  // P (16 keys x 8 heads)
    float acc[kMaxGroup][4];
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }

    for (int it = 0; it < n_st; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < n_st) load_stage(it + kStages - 1, (it + kStages - 1) % kStages);
      cp_async_commit();

      const int slot = it % kStages;
      const int wk0 = k0 + it * kStageKeys + warp * 16;
      if (wk0 >= k_end) continue;
      const unsigned char* kb = ring + slot * L::kStageBytes + warp * 16 * L::kRowBytes;
      const unsigned char* vb = kb + kStageKeys * L::kRowBytes;
      const float* ksc = scales + (slot * 2) * kStageKeys + warp * 16;
      const float* vsc = ksc + kStageKeys;

      const KT* krow = reinterpret_cast<const KT*>(kb + key * L::kRowBytes);
      const float sk = kQuant ? ksc[key] : 1.f;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < kHead; ++d) {
        float kf;
        if constexpr (kQuant) {
          kf = byte_to_float<KT>(reinterpret_cast<const uint8_t*>(krow)[d]) * sk;
        } else {
          kf = to_f(krow[d]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = fmaf(qf[(hq * 4 + i) * L::kLdq + d], kf, s[i]);
      }
      const bool live = wk0 + key < k_end;
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!live) s[i] = -INFINITY;
        float mx = s[i];
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[i], mx);  // finite: key wk0 is live
        al[i] = exp2f(m[i] - mn);
        m[i] = mn;
        const float p = exp2f(s[i] - mn);
        l[i] = l[i] * al[i] + p;
        pf[key * kMaxGroup + hq * 4 + i] = p;  // fp32: the rounding is exact
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        const float a = __shfl_sync(0xffffffffu, al[h & 3], (h >> 2) * 16);
        if (h < G) {
          acc[h][0] *= a;
          acc[h][1] *= a;
          acc[h][2] *= a;
          acc[h][3] *= a;
        }
      }
      const int n_live = min(16, k_end - wk0);
      for (int kk = 0; kk < n_live; ++kk) {
        float vf[4];
        const unsigned char* vrow = vb + kk * L::kRowBytes;
        if constexpr (kQuant) {
          const uint32_t x = *reinterpret_cast<const uint32_t*>(vrow + 4 * lane);
          const float sv = vsc[kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) vf[j] = byte_to_float<KT>(x >> (8 * j)) * sv;
        } else {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 16 * lane);
          vf[0] = x.x;
          vf[1] = x.y;
          vf[2] = x.z;
          vf[3] = x.w;
        }
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h) {
          if (h < G) {
            const float p = pf[kk * kMaxGroup + h];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[h][j] = fmaf(p, vf[j], acc[h][j]);
          }
        }
      }
      __syncwarp();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
    }
    cp_async_wait<0>();
    __syncthreads();
    float* o_s = reinterpret_cast<float*>(ring);
    if (key == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m_s[warp * kMaxGroup + hq * 4 + i] = m[i];
        l_s[warp * kMaxGroup + hq * 4 + i] = l[i];
      }
    }
    float* ow = o_s + warp * kMaxGroup * kHead;
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      *reinterpret_cast<float4*>(ow + h * kHead + 4 * lane) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    }
  }
  __syncthreads();

  // merge the four warps; thread tid owns head-dim column tid
  const float* o_s = reinterpret_cast<const float*>(ring);
  const int64_t n_part = static_cast<int64_t>(gridDim.z) * gridDim.y * gridDim.x * G;
  for (int h = 0; h < G; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kMaxGroup + h]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kMaxGroup + h] - mx);  // an idle warp: 0
      lsum += l_s[w * kMaxGroup + h] * f;
      osum += o_s[(w * kMaxGroup + h) * kHead + tid] * f;
    }
    const int64_t idx = ((static_cast<int64_t>(b) * nkv + kvh) * gridDim.x + split) * G + h;
    part_o[idx * kHead + tid] = osum;
    if (tid == 0) {
      part_ml[idx] = mx;
      part_ml[n_part + idx] = lsum;
    }
  }
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is reused
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// grid (Nq, B): merge a row's live splits for one query head,
// o = sum(o_s 2^(m_s - M)) / sum(l_s 2^(m_s - M)). The splits' weights are
// computed in parallel into shared memory (n_splits floats); thread tid
// then sums head-dim column tid over the splits.
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ seq_lens, QT* __restrict__ out, int n_splits, int capacity,
    int group, int split_keys) {
  extern __shared__ float weight[];  // n_splits
  __shared__ float red[kWarps];
  const int G = group;
  const int qh = blockIdx.x;  // kv head qh / G, query head qh % G of the group
  const int b = blockIdx.y;
  const int nq = gridDim.x;
  const int kvh = qh / G;
  const int h = qh - kvh * G;
  const int tid = threadIdx.x;
  const int pos = seq_lens[b];
  const int n_keys = pos < 0 ? 0 : min(pos + 1, capacity);
  const int n_live = (n_keys + split_keys - 1) / split_keys;
  const int64_t n_part = static_cast<int64_t>(gridDim.y) * nq * n_splits;
  // partial s of this head sits at base + s * G
  const int64_t base =
      ((static_cast<int64_t>(b) * (nq / G) + kvh) * n_splits) * G + h;

  float mx = -INFINITY;
  for (int sp = tid; sp < n_live; sp += kThreads) mx = fmaxf(mx, part_ml[base + sp * G]);
  mx = block_reduce(mx, red, true);
  float lsum = 0.f;
  for (int sp = tid; sp < n_live; sp += kThreads) {
    const int64_t idx = base + sp * G;
    const float f = exp2f(part_ml[idx] - mx);
    weight[sp] = f;
    lsum += part_ml[n_part + idx] * f;
  }
  lsum = block_reduce(lsum, red, false);  // its barriers publish weight[]
  float osum = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_live; ++sp) {
    osum = fmaf(part_o[(base + sp * G) * kHead + tid], weight[sp], osum);
  }
  out[(static_cast<int64_t>(b) * nq + qh) * kHead + tid] =
      from_f<QT>(lsum == 0.f ? 0.f : osum / lsum);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const void* k_scales;
  const void* v_scales;
  const void* page_table;
  const void* seq_lens;
  void* out;
  void* part_o;
  void* part_ml;
  int batch, nkv, page_size, max_pages, group, split_keys, n_splits;
  float q_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const Args& a) {
  using L = Layout<QT, KT, kQuant>;
  auto kernel = paged_decode_split_kernel<QT, KT, kQuant>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_splits, a.nkv, a.batch), kThreads, L::kBytes, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.seq_lens), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), a.nkv, a.page_size, a.max_pages, a.group, a.split_keys,
      a.q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int combine_smem = a.n_splits * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(paged_decode_combine_kernel<QT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, combine_smem);
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<QT>
      <<<dim3(a.nkv * a.group, a.batch), kThreads, combine_smem, a.stream>>>(
      static_cast<const float*>(a.part_o), static_cast<const float*>(a.part_ml),
      static_cast<const int*>(a.seq_lens), static_cast<QT*>(a.out), a.n_splits,
      a.max_pages * a.page_size, a.group, a.split_keys);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_pool(int kv_dtype, int q_dtype, const Args& a) {
  const bool quant = a.k_scales != nullptr;
  if (kv_dtype == kI8 && quant) return launch<QT, int8_t, true>(a);
  if (kv_dtype == kE4M3 && quant) return launch<QT, __nv_fp8_e4m3, true>(a);
  if (kv_dtype == q_dtype && !quant) return launch<QT, QT, false>(a);
  return cudaErrorInvalidValue;
}

template <typename QT>
int smem_bytes(int kv_dtype, int q_dtype) {
  if (kv_dtype == kI8) return Layout<QT, int8_t, true>::kBytes;
  if (kv_dtype == kE4M3) return Layout<QT, __nv_fp8_e4m3, true>::kBytes;
  if (kv_dtype == q_dtype) return Layout<QT, QT, false>::kBytes;
  return -1;
}

}  // namespace

// Dynamic shared memory of the split kernel for a (q, pool) dtype pair, -1
// for a pair it does not take (reported by chip_smoke.py's build phase).
extern "C" int paged_decode_smem_bytes(int q_dtype, int kv_dtype) {
  switch (q_dtype) {
    case kF32:
      return smem_bytes<float>(kv_dtype, q_dtype);
    case kBF16:
      return smem_bytes<__nv_bfloat16>(kv_dtype, q_dtype);
    case kF16:
      return smem_bytes<__half>(kv_dtype, q_dtype);
    default:
      return -1;
  }
}

// Plain C entry point, bound with ctypes. Pointers and the stream travel as
// void*; the return value is the cudaError_t of the launches (0 on success).
// q_scale is head_dim ** -0.5 * log2(e), already rounded to q's dtype.
// part_o (B, Nkv, n_splits, group, H) and part_ml (2, B, Nkv, n_splits,
// group) are fp32 scratch allocated by the caller; split_keys * n_splits
// must cover max_pages * page_size.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scales, const void* v_scales,
                            const void* page_table, const void* seq_lens, void* out,
                            void* part_o, void* part_ml, int batch, int nq, int nkv,
                            int head_dim, int page_size, int max_pages, int split_keys,
                            int n_splits, int q_dtype, int kv_dtype, float q_scale,
                            void* stream) {
  if (batch <= 0 || nkv <= 0 || nq % nkv != 0 || head_dim != kHead || page_size <= 0 ||
      nq / nkv > kMaxGroup || split_keys <= 0 || split_keys % kStageKeys != 0 ||
      n_splits <= 0 || static_cast<int64_t>(split_keys) * n_splits <
                           static_cast<int64_t>(max_pages) * page_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,        k_pages,  v_pages, k_scales, v_scales,   page_table,
               seq_lens, out,      part_o,  part_ml,  batch,      nkv,
               page_size, max_pages, nq / nkv, split_keys, n_splits, q_scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_pool<float>(kv_dtype, q_dtype, a);
      break;
    case kBF16:
      err = dispatch_pool<__nv_bfloat16>(kv_dtype, q_dtype, a);
      break;
    case kF16:
      err = dispatch_pool<__half>(kv_dtype, q_dtype, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
