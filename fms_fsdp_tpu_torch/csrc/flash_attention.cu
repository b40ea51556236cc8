// Causal / full grouped-query flash attention for fp32 inputs: the
// forward, the dq backward and the dk/dv backward, on the CUDA cores. The
// 16-bit kernels are flash_fwd_sm90.cu (forward) and flash_bwd_sm90.cu (dq,
// dk/dv), wgmma fed by TMA; ops/flash_attention.py dispatches by dtype.
//
// Replaces, for fp32, the five Pallas kernels of
// fms_fsdp_tpu/ops/flash_attention.py:
//   - flash_fwd: _fwd_kernel (:62, KV resident in VMEM) and
//     _fwd_kernel_kvgrid (:179, KV streamed over a grid axis);
//   - flash_dq:  _dq_kernel (:318) and _dq_kernel_kvgrid (:368);
//   - flash_dkv: _dkv_kernel (:484).
// The resident/kvgrid split exists on the TPU only because of VMEM. No
// Hopper block holds a whole sequence in shared memory, so the forward and
// the dq kernel here always stream K/V tile by tile, and one kernel fulfils
// both contracts at any sequence length.
//
// Layout: q, o, dout, dq (B, Sq, Nq, H); k, v (B, Sk, Nkv, H), all
// contiguous, as the model produces them (no transpose to (B, N, S, H)).
// lse and delta are fp32 (B, Nq, Sq). dk and dv come out fp32
// (B, Sk, Nkv, H), as the TPU kernel's outputs. Head dim 128; Sq and Sk
// multiples of 64; Nq a multiple of Nkv (query head h reads kv head
// h / (Nq / Nkv)). Causal masking is top-left aligned: query i sees keys
// <= i, also when Sq != Sk.
//
// Numerics, the same rounding points as the TPU kernels (at fp32 the
// roundings to the input type are exact): q is scaled by scale * log2(e);
// the online softmax runs in base 2; lse is returned in natural log; ds =
// p * (dp - delta) * scale.
//
// What bounds these kernels on the H100: fp32 operations on the CUDA cores
// (TF32 tensor cores would change the numbers). Each of the four warps of
// a block owns 16 rows; thread (g = lane / 4, t = lane % 4) holds rows g
// and g + 8 of its warp, columns 8j + 2t and 8j + 2t + 1 (the layout of an
// mma accumulator), so scores and sums stay in registers; P and dS pass
// through a per-warp scratch to the next product. Tiles are staged in
// shared memory with cp.async, rows padded by 4 floats against bank
// conflicts. Causal blocks skip the tiles above the diagonal and mask only
// the diagonal tile; forward and dq blocks start with the longest rows;
// dk/dv accumulate in fp32 registers over the GQA group and the q walk
// inside one block per (batch, kv head, k tile): no atomics, so the result
// is deterministic. A k tile that no query reaches (causal, Sk > Sq)
// writes zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHead = 128;    // head dim
constexpr int kThreads = 128; // four warps
constexpr int kBQ = 64;       // query rows of a forward / dq block, 16 per warp
constexpr int kBK = 64;       // keys per tile, and keys of a dk/dv block
constexpr int kBQd = 32;      // query rows per step of the dk/dv walk
constexpr int kLd = kHead + 4;  // row stride of a staged tile, floats
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype code shared with the Python wrapper: the only one these kernels
// take
constexpr int kF32 = 0;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy kRows rows of H floats into shared memory (row stride kLd): row r
// of the tile starts at element row0 + r * stride of g.
template <int kRows>
__device__ __forceinline__ void load_rows(float* sm, const float* __restrict__ g, int64_t row0,
                                          int64_t stride, int tid) {
  constexpr int kChunks = kHead / 4;
#pragma unroll
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    cp_async16(sm + r * kLd + col, g + row0 + r * stride + col);
  }
}

// n consecutive fp32 values (n a multiple of 4)
__device__ __forceinline__ void load_f32(float* sm, const float* __restrict__ g, int n, int tid) {
  for (int c = tid; c < n / 4; c += kThreads) cp_async16(sm + 4 * c, g + 4 * c);
}

// dst = src * c over a tile of kRows rows
template <int kRows>
__device__ __forceinline__ void scale_rows(float* dst, const float* src, float c, int tid) {
  for (int i = tid; i < kRows * kHead; i += kThreads) {
    const int r = i / kHead;
    const int col = i - r * kHead;
    dst[r * kLd + col] = src[r * kLd + col] * c;
  }
}

// acc (16 x 8*NT, accumulator layout) += A * B1.
// A: the warp's 16 rows (row-major, stride lda) over K columns.
// B1(k, n) = Bs[n * ldb + k]: the product runs against the rows of Bs.
template <int NT, int K>
__device__ __forceinline__ void gemm_ab1(float (&acc)[NT][4], const float* A, int lda,
                                         const float* Bs, int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k];
    const float a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = Bs[(j * 8 + 2 * t) * ldb + k];
      const float b1 = Bs[(j * 8 + 2 * t + 1) * ldb + k];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// acc (16 x 8*NT) += P * B2, with P (16 x K) held in the accumulator
// layout (p[K / 8][4]) and B2(k, n) = Bs[k * ldb + n]. P is staged
// through the warp's scratch (16 x (K + 4) floats).
template <int NT, int K>
__device__ __forceinline__ void gemm_pb2(float (&acc)[NT][4], const float (&p)[K / 8][4],
                                         const float* Bs, int ldb, float* scratch, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  constexpr int kLds = K + 4;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    scratch[g * kLds + j * 8 + 2 * t] = p[j][0];
    scratch[g * kLds + j * 8 + 2 * t + 1] = p[j][1];
    scratch[(g + 8) * kLds + j * 8 + 2 * t] = p[j][2];
    scratch[(g + 8) * kLds + j * 8 + 2 * t + 1] = p[j][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = scratch[g * kLds + k];
    const float a1 = scratch[(g + 8) * kLds + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = Bs[k * ldb + j * 8 + 2 * t];
      const float b1 = Bs[k * ldb + j * 8 + 2 * t + 1];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
  __syncwarp();  // the scratch is rewritten by the next call
}

constexpr int scratch_floats(int k) { return 4 * 16 * (k + 4); }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Q, one K/V tile and the per-warp P scratch
constexpr int kFwdSmemBytes = (kBQ + 2 * kBK) * kLd * 4 + scratch_floats(kBK) * 4;

// grid (Sq / 64, Nq, B): one block per (q tile, q head, batch). The one
// K/V tile is refilled once its products are done.
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int sq, int sk, int nq, int nkv, int causal,
    float q_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBQ * kLd;
  float* v_s = k_s + kBK * kLd;
  float* scratch = v_s + kBK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBQ;
  const int64_t q_base = ((static_cast<int64_t>(b) * sq + q0) * nq + h) * kHead;
  const int64_t q_stride = static_cast<int64_t>(nq) * kHead;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * kHead;
  const int64_t kv_base = (static_cast<int64_t>(b) * sk * nkv + kvh) * kHead;

  int n_kt = sk / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  load_rows<kBQ>(q_s, q, q_base, q_stride, tid);
  load_rows<kBK>(k_s, k, kv_base, kv_stride, tid);
  load_rows<kBK>(v_s, v, kv_base, kv_stride, tid);
  cp_async_commit();

  float acc[kHead / 8][4];
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2), rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominators
  const int r0 = q0 + warp * 16 + g;     // the thread's two query rows
  const int r1 = r0 + 8;
  const float* qw = q_s + warp * 16 * kLd;
  float* wscratch = scratch + warp * 16 * (kBK + 4);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt == 0) {
      scale_rows<kBQ>(q_s, q_s, q_scale, tid);
      __syncthreads();
    }

    // scores in the base-2 domain: s = q2 . k
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    gemm_ab1<kBK / 8, kHead>(s, qw, kLd, k_s, kLd, lane);

    if (causal && kt * kBK + kBK - 1 > q0) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int key = kt * kBK + j * 8 + 2 * t;
        if (key > r0) s[j][0] = -INFINITY;
        if (key + 1 > r0) s[j][1] = -INFINITY;
        if (key > r1) s[j][2] = -INFINITY;
        if (key + 1 > r1) s[j][3] = -INFINITY;
      }
    }
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
      tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
    }
    // finite: every row sees at least one key of every tile it visits
    const float mn0 = fmaxf(m0, quad_max(tm0));
    const float mn1 = fmaxf(m1, quad_max(tm1));
    const float al0 = exp2f(m0 - mn0);  // first tile: exp2(-inf) = 0
    const float al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);  // masked: exp2(-inf) = 0
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int j = 0; j < kHead / 8; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    // acc += p . v
    gemm_pb2<kHead / 8, kBK>(acc, s, v_s, kLd, wscratch, lane);
    __syncthreads();  // the tile is refilled next
    if (kt + 1 < n_kt) {
      const int64_t off = kv_base + static_cast<int64_t>(kt + 1) * kBK * kv_stride;
      load_rows<kBK>(k_s, k, off, kv_stride, tid);
      load_rows<kBK>(v_s, v, off, kv_stride, tid);
      cp_async_commit();
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  float* o0 = o + q_base + static_cast<int64_t>(warp * 16 + g) * q_stride;
  float* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) {
    const int col = j * 8 + 2 * t;
    store2(o0 + col, acc[j][0] * inv0, acc[j][1] * inv0);
    store2(o1 + col, acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (t == 0) {
    float* lrow = lse + (static_cast<int64_t>(b) * nq + h) * sq;
    lrow[r0] = m0 * kLn2 + logf(l0);
    lrow[r1] = m1 * kLn2 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

// Q, dO, one K/V tile and the per-warp dS scratch
constexpr int kDqSmemBytes = (2 * kBQ + 2 * kBK) * kLd * 4 + scratch_floats(kBK) * 4;

// grid (Sq / 64, Nq, B). dq = sum over key tiles of ds . k with
// ds = p * (dp - delta) * scale, p = exp2(s - lse * log2(e)), dp = do . v
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int sq, int sk, int nq, int nkv,
    int causal, float q_scale, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kBQ * kLd;
  float* k_s = do_s + kBQ * kLd;
  float* v_s = k_s + kBK * kLd;
  float* scratch = v_s + kBK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBQ;
  const int64_t q_base = ((static_cast<int64_t>(b) * sq + q0) * nq + h) * kHead;
  const int64_t q_stride = static_cast<int64_t>(nq) * kHead;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * kHead;
  const int64_t kv_base = (static_cast<int64_t>(b) * sk * nkv + kvh) * kHead;

  int n_kt = sk / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  load_rows<kBQ>(q_s, q, q_base, q_stride, tid);
  load_rows<kBQ>(do_s, dout, q_base, q_stride, tid);
  load_rows<kBK>(k_s, k, kv_base, kv_stride, tid);
  load_rows<kBK>(v_s, v, kv_base, kv_stride, tid);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const int64_t stat = (static_cast<int64_t>(b) * nq + h) * sq;
  const float lse0 = lse[stat + r0] * kLog2e;
  const float lse1 = lse[stat + r1] * kLog2e;
  const float dl0 = delta[stat + r0];
  const float dl1 = delta[stat + r1];

  float acc[kHead / 8][4];
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float* qw = q_s + warp * 16 * kLd;
  const float* dow = do_s + warp * 16 * kLd;
  float* wscratch = scratch + warp * 16 * (kBK + 4);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt == 0) {
      scale_rows<kBQ>(q_s, q_s, q_scale, tid);
      __syncthreads();
    }

    float s[kBK / 8][4];
    float dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    gemm_ab1<kBK / 8, kHead>(s, qw, kLd, k_s, kLd, lane);
    if (causal && kt * kBK + kBK - 1 > q0) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int key = kt * kBK + j * 8 + 2 * t;
        if (key > r0) s[j][0] = -INFINITY;
        if (key + 1 > r0) s[j][1] = -INFINITY;
        if (key > r1) s[j][2] = -INFINITY;
        if (key + 1 > r1) s[j][3] = -INFINITY;
      }
    }
    gemm_ab1<kBK / 8, kHead>(dp, dow, kLd, v_s, kLd, lane);  // dp = do . v
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - lse0) * (dp[j][0] - dl0) * scale;
      s[j][1] = exp2f(s[j][1] - lse0) * (dp[j][1] - dl0) * scale;
      s[j][2] = exp2f(s[j][2] - lse1) * (dp[j][2] - dl1) * scale;
      s[j][3] = exp2f(s[j][3] - lse1) * (dp[j][3] - dl1) * scale;
    }
    // dq += ds . k
    gemm_pb2<kHead / 8, kBK>(acc, s, k_s, kLd, wscratch, lane);
    __syncthreads();
    if (kt + 1 < n_kt) {
      const int64_t off = kv_base + static_cast<int64_t>(kt + 1) * kBK * kv_stride;
      load_rows<kBK>(k_s, k, off, kv_stride, tid);
      load_rows<kBK>(v_s, v, off, kv_stride, tid);
      cp_async_commit();
    }
  }

  float* d0 = dq + q_base + static_cast<int64_t>(warp * 16 + g) * q_stride;
  float* d1 = d0 + 8 * q_stride;
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) {
    const int col = j * 8 + 2 * t;
    store2(d0 + col, acc[j][0], acc[j][1]);
    store2(d1 + col, acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

// per step: q, q2 and do tiles, then the lse and delta of its rows
constexpr int kStageBytes = 3 * kBQd * kLd * 4 + 2 * kBQd * 4;
constexpr int kDkvSmemBytes = 2 * kBK * kLd * 4 + kStageBytes + scratch_floats(kBQd) * 4;

// grid (Sk / 64, Nkv, B): one block per (k tile, kv head, batch). The
// block keeps its K and V tiles and walks the query heads of its group and,
// under causality, the query tiles from the diagonal on; dk and dv sum in
// fp32 registers and are written once. q2 is q scaled by scale * log2(e),
// made once by the wrapper: each q tile is read by every k tile of its
// head, so scaling it here would repeat the work Sk / 64 times.
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ q2, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int sq,
    int sk, int nq, int nkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kBK * kLd;
  float* q_b = v_s + kBK * kLd;  // the step's q, q2, do, lse, delta
  float* q2_b = q_b + kBQd * kLd;
  float* do_b = q2_b + kBQd * kLd;
  float* lse_b = do_b + kBQd * kLd;
  float* dl_b = lse_b + kBQd;
  float* scratch = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(q_b) + kStageBytes);

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nq / nkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kBK;
  const int64_t q_stride = static_cast<int64_t>(nq) * kHead;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * kHead;
  const int64_t kv_base = ((static_cast<int64_t>(b) * sk + k0) * nkv + kvh) * kHead;

  const int n_qd = sq / kBQd;
  const int qi_lo = causal ? min(k0 / kBQd, n_qd) : 0;  // first tile with a q >= k0
  const int n_q = n_qd - qi_lo;
  const int n_it = group * n_q;

  auto fetch = [&](int it) {
    const int h = kvh * group + it / n_q;
    const int q0 = (qi_lo + it % n_q) * kBQd;
    const int64_t q_base = ((static_cast<int64_t>(b) * sq + q0) * nq + h) * kHead;
    const int64_t stat = (static_cast<int64_t>(b) * nq + h) * sq + q0;
    load_rows<kBQd>(q_b, q, q_base, q_stride, tid);
    load_rows<kBQd>(q2_b, q2, q_base, q_stride, tid);
    load_rows<kBQd>(do_b, dout, q_base, q_stride, tid);
    load_f32(lse_b, lse + stat, kBQd, tid);
    load_f32(dl_b, delta + stat, kBQd, tid);
  };

  load_rows<kBK>(k_s, k, kv_base, kv_stride, tid);
  load_rows<kBK>(v_s, v, kv_base, kv_stride, tid);
  if (n_it > 0) fetch(0);
  cp_async_commit();

  float dk_acc[kHead / 8][4];
  float dv_acc[kHead / 8][4];
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // the thread's two key rows
  const int key1 = key0 + 8;
  const float* kw = k_s + warp * 16 * kLd;
  const float* vw = v_s + warp * 16 * kLd;
  float* wscratch = scratch + warp * 16 * (kBQd + 4);

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int q0 = (qi_lo + it % n_q) * kBQd;

    // transposed scores s^T = k . q2 (keys x queries), base-2 domain
    float st[kBQd / 8][4];
    float dpt[kBQd / 8][4];
#pragma unroll
    for (int j = 0; j < kBQd / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
    gemm_ab1<kBQd / 8, kHead>(st, kw, kLd, q2_b, kLd, lane);
    const bool masked = causal && q0 < k0 + kBK - 1;
#pragma unroll
    for (int j = 0; j < kBQd / 8; ++j) {
      const int c = j * 8 + 2 * t;  // query columns c, c + 1 of the tile
      const float la = lse_b[c] * kLog2e;
      const float lb = lse_b[c + 1] * kLog2e;
      if (masked) {
        if (q0 + c < key0) st[j][0] = -INFINITY;
        if (q0 + c + 1 < key0) st[j][1] = -INFINITY;
        if (q0 + c < key1) st[j][2] = -INFINITY;
        if (q0 + c + 1 < key1) st[j][3] = -INFINITY;
      }
      st[j][0] = exp2f(st[j][0] - la);
      st[j][1] = exp2f(st[j][1] - lb);
      st[j][2] = exp2f(st[j][2] - la);
      st[j][3] = exp2f(st[j][3] - lb);
    }
    // dv += p^T . do
    gemm_pb2<kHead / 8, kBQd>(dv_acc, st, do_b, kLd, wscratch, lane);
    // dp^T = v . do
    gemm_ab1<kBQd / 8, kHead>(dpt, vw, kLd, do_b, kLd, lane);
#pragma unroll
    for (int j = 0; j < kBQd / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float da = dl_b[c];
      const float db = dl_b[c + 1];
      st[j][0] = st[j][0] * (dpt[j][0] - da) * scale;
      st[j][1] = st[j][1] * (dpt[j][1] - db) * scale;
      st[j][2] = st[j][2] * (dpt[j][2] - da) * scale;
      st[j][3] = st[j][3] * (dpt[j][3] - db) * scale;
    }
    // dk += ds^T . q (q unscaled)
    gemm_pb2<kHead / 8, kBQd>(dk_acc, st, q_b, kLd, wscratch, lane);
    __syncthreads();
    if (it + 1 < n_it) {
      fetch(it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // n_it == 0: the K/V loads are still in flight

  float* dk0 = dk + kv_base + static_cast<int64_t>(warp * 16 + g) * kv_stride;
  float* dk1 = dk0 + 8 * kv_stride;
  float* dv0 = dv + kv_base + static_cast<int64_t>(warp * 16 + g) * kv_stride;
  float* dv1 = dv0 + 8 * kv_stride;
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) {
    const int col = j * 8 + 2 * t;
    store2(dk0 + col, dk_acc[j][0], dk_acc[j][1]);
    store2(dk1 + col, dk_acc[j][2], dk_acc[j][3]);
    store2(dv0 + col, dv_acc[j][0], dv_acc[j][1]);
    store2(dv1 + col, dv_acc[j][2], dv_acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_input(int batch, int sq, int sk, int nq, int nkv, int head_dim, int dtype) {
  return dtype != kF32 || batch <= 0 || nkv <= 0 || nq % nkv != 0 || head_dim != kHead ||
         sq <= 0 || sk <= 0 || sq % kBQ != 0 || sk % kBK != 0;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers and the stream travel
// as void*; each returns the cudaError_t of its launch (0 on success), and
// cudaErrorInvalidValue for a dtype other than fp32 (16-bit inputs go to
// flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90) or a shape the kernels
// do not take. q_scale is scale * log2(e); scale is the softmax scale;
// flash_dkv takes q already scaled (q2) beside q.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int sq, int sk, int nq, int nkv, int head_dim, int causal,
                         int dtype, float q_scale, void* stream) {
  if (bad_input(batch, sq, sk, nq, nkv, head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_kernel, kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<<<dim3(sq / kBQ, nq, batch), kThreads, kFwdSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), sq, sk, nq, nkv, causal, q_scale);
  return cudaGetLastError();
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq_out, int batch, int sq,
                        int sk, int nq, int nkv, int head_dim, int causal, int dtype,
                        float q_scale, float scale, void* stream) {
  if (bad_input(batch, sq, sk, nq, nkv, head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dq_kernel, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<<<dim3(sq / kBQ, nq, batch), kThreads, kDqSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_out), sq, sk, nq, nkv, causal,
      q_scale, scale);
  return cudaGetLastError();
}

extern "C" int flash_dkv(const void* q, const void* q2, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int batch, int sq, int sk, int nq, int nkv, int head_dim,
                         int causal, int dtype, float scale, void* stream) {
  if (bad_input(batch, sq, sk, nq, nkv, head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dkv_kernel, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<<<dim3(sk / kBK, nkv, batch), kThreads, kDkvSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, nq, nkv, causal, scale);
  return cudaGetLastError();
}
