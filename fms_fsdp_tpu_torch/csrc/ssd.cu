// Fused whole-sequence Mamba2 SSD (state-space dual) scan for Hopper
// (sm_90a), forward, fp32 inputs. bf16 and fp16 inputs run the kernel of
// ssd_sm90.cu.
//
// Replaces, for fp32, the Pallas kernel fms_fsdp_tpu/ops/ssd.py:51
// `_fused_kernel` (call :186). Per chunk of L tokens of one head it computes
//
//   cum_i = sum(a[0..i])                (chunk-local, fp32)
//   w_ij  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y_i   = sum_j round_T(w_ij) x_j + exp(cum_i) * (C_i . round_T(s_prev))
//   s_new = exp(cum_L-1) * s_prev
//           + sum_l B_l^T (x_l * round_T(exp(cum_L-1 - cum_l) * dt_l))
//
// with s (N, P) fp32 carried from chunk to chunk (zero before the first),
// every product accumulated in fp32, and the three casts to the input type
// T where the TPU kernel makes them (no-ops for fp32). y has no D term.
//
// Layout: x (B, S, H, P) and Bm/Cm (B, S, G, N) of type T, read through
// their batch and token strides as the model produces them (views into the
// convolution's output; nothing is transposed head-major as the TPU wrapper
// must); dt and a = dt * A (B, S, H) fp32 contiguous; y (B, S, H, P) fp32
// contiguous. Head h reads group h / (H / G). P = 64, N = 128, L a multiple
// of 64 up to 256, S a multiple of L.
//
// What was thought through again for this card:
//   - The grid. On the TPU the grid is (batch, group, chunk, head in group)
//     with the last two axes sequential, so only batch x group cells are
//     independent: two at the training shape (B = 2, G = 1). Here the chunk
//     sweep is a loop inside the block and the grid is (head, batch): 256
//     independent blocks at that shape, two resident on each SM.
//   - C.B^T. The TPU kernel computes the (L, L) product once per (batch,
//     group, chunk) and the group's other heads reuse it from VMEM, which
//     works because they run one after another on one core. Blocks here run
//     in no order, so every head recomputes it: 2*L*L*N operations against
//     the 2*L*L*P of the product it feeds (N = 128, P = 64), three times
//     the intra-chunk work, and no scratch in device memory, no second
//     kernel and no ordering between blocks. B and C tiles of a group are
//     read by all its heads and come from L2 after the first.
//   - The (L, L) tile. 256 x 256 fp32 does not fit a block's shared memory;
//     the chunk is walked in 64 x 64 tiles, lower triangle only, the scores
//     of a tile living in registers in the mma accumulator layout. The mask
//     is i >= j inside the chunk and a masked weight is 0 (never
//     exp(+large) * 0).
//   - The cumulative sum is taken inside the kernel (a warp scan per
//     chunk); the TPU wrapper precomputes it only because Pallas cannot.
//   - The state stays in shared memory for the whole sweep: fp32 (N, P),
//     plus its copy rounded to T, which is the operand of C . s_prev.
//
// What bounds it on the H100: operations. At B=2, S=4096, H=128, P=64,
// N=128, G=1, L=256 the chunked algorithm is 69 GFLOP, 1.03 ms at the fp32
// SIMT rate (TF32 tensor cores would change the numbers), against 0.55 GB
// of operands. It is a first, simple kernel: scalar FMA in the mma
// accumulator layout, tiles staged with cp.async without a pipeline (the
// second block of the SM hides some of the latency).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kP = 64;         // head dim
constexpr int kN = 128;        // state dim
constexpr int kT = 64;         // tokens of a tile, 16 per warp
constexpr int kMaxL = 256;     // longest chunk
constexpr int kThreads = 128;  // four warps
constexpr int kLdS = kP + 4;   // row stride of the fp32 state

constexpr int kF32 = 0;  // dtype code of the Python wrapper

constexpr int kPad = 4;  // row padding of the staged tiles, in elements

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// kT rows of kCols elements into shared memory (row stride ld); row r of
// the tile starts at g + r * stride
template <typename T, int kCols>
__device__ __forceinline__ void load_tile(T* sm, int ld, const T* __restrict__ g, int64_t stride,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kCols / kVec;
  for (int c = tid; c < kT * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    cp_async16(sm + r * ld + col, g + r * stride + col);
  }
}

// The four products below share one accumulator layout: acc (16 x 8*NT),
// thread (g = lane / 4, t = lane % 4) owns acc[j] = rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1.

// acc += A * B1. A: the warp's 16 rows (row-major, stride lda) over K
// columns. B1(k, n) = Bs[n * ldb + k]: the product runs against the rows
// of Bs.
template <typename T, int NT, int K>
__device__ __forceinline__ void gemm_ab1(float (&acc)[NT][4], const T* A, int lda, const T* Bs,
                                         int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = to_f(A[g * lda + k]);
    const float a1 = to_f(A[(g + 8) * lda + k]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = to_f(Bs[(j * 8 + 2 * t) * ldb + k]);
      const float b1 = to_f(Bs[(j * 8 + 2 * t + 1) * ldb + k]);
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// acc += A * B2. A as in gemm_ab1; B2(k, n) = Bs[k * ldb + n].
template <typename T, int NT, int K>
__device__ __forceinline__ void gemm_ab2(float (&acc)[NT][4], const T* A, int lda, const T* Bs,
                                         int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = to_f(A[g * lda + k]);
    const float a1 = to_f(A[(g + 8) * lda + k]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = to_f(Bs[k * ldb + j * 8 + 2 * t]);
      const float b1 = to_f(Bs[k * ldb + j * 8 + 2 * t + 1]);
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// acc += A^T * B2 with A(m, k) = As[k * lda + m] (16 columns of As, the
// caller has added the column offset) and B2(k, n) = Bs[k * ldb + n].
template <typename T, int NT, int K>
__device__ __forceinline__ void gemm_atb2(float (&acc)[NT][4], const T* As, int lda, const T* Bs,
                                          int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = to_f(As[k * lda + g]);
    const float a1 = to_f(As[k * lda + g + 8]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = to_f(Bs[k * ldb + j * 8 + 2 * t]);
      const float b1 = to_f(Bs[k * ldb + j * 8 + 2 * t + 1]);
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// acc += round_T(W) * B2, with W (16 x K) held in the accumulator layout
// (w[K / 8][4]) and B2(k, n) = Bs[k * ldb + n]. 16-bit types pack W
// straight into A fragments; fp32 stages it through the warp's scratch
// (16 x (K + 4) floats).
template <typename T, int NT, int K>
__device__ __forceinline__ void gemm_wb2(float (&acc)[NT][4], const float (&w)[K / 8][4],
                                         const T* Bs, int ldb, float* scratch, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  constexpr int kLds = K + 4;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    scratch[g * kLds + j * 8 + 2 * t] = w[j][0];
    scratch[g * kLds + j * 8 + 2 * t + 1] = w[j][1];
    scratch[(g + 8) * kLds + j * 8 + 2 * t] = w[j][2];
    scratch[(g + 8) * kLds + j * 8 + 2 * t + 1] = w[j][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = scratch[g * kLds + k];
    const float a1 = scratch[(g + 8) * kLds + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = to_f(Bs[k * ldb + j * 8 + 2 * t]);
      const float b1 = to_f(Bs[k * ldb + j * 8 + 2 * t + 1]);
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
  __syncwarp();  // the scratch is rewritten by the next call
}

template <typename T>
constexpr int smem_bytes() {
  constexpr int kLdN = kN + kPad;
  constexpr int kLdP = kP + kPad;
  constexpr int tiles = (2 * kT * kLdN + kT * kLdP + kN * kLdP) * static_cast<int>(sizeof(T));
  constexpr int scratch = 4 * 16 * (kT + 4) * 4;
  return tiles + kN * kLdS * 4 + 3 * kMaxL * 4 + scratch;
}

// grid (H, B): one block per (head, batch), the chunk sweep inside it
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fused_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y, int S, int H, int G,
    int L, int64_t x_bs, int64_t x_rs, int64_t b_bs, int64_t b_rs, int64_t c_bs, int64_t c_rs) {
  constexpr int kLdN = kN + kPad;
  constexpr int kLdP = kP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* c_s = reinterpret_cast<T*>(smem);   // C rows of the row tile
  T* b_s = c_s + kT * kLdN;              // B rows of the column tile
  T* x_s = b_s + kT * kLdN;              // x rows of the column tile
  T* st_s = x_s + kT * kLdP;             // round_T(s_prev), (N, P)
  float* state = reinterpret_cast<float*>(st_s + kN * kLdP);  // (N, P) fp32
  float* cum_s = state + kN * kLdS;      // chunk-local cumsum of a
  float* dt_s = cum_s + kMaxL;
  float* rd_s = dt_s + kMaxL;            // round_T(exp(total - cum) * dt)
  float* scratch = rd_s + kMaxL;         // the warps' weight tiles

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* xh = x + b * x_bs + static_cast<int64_t>(h) * kP;
  const T* Bg = Bm + b * b_bs + static_cast<int64_t>(grp) * kN;
  const T* Cg = Cm + b * c_bs + static_cast<int64_t>(grp) * kN;
  const int64_t bh = static_cast<int64_t>(b) * S * H + h;  // + token * H
  const int64_t y_rs = static_cast<int64_t>(H) * kP;
  float* yh = y + bh * kP;
  float* wscratch = scratch + warp * 16 * (kT + 4);

  for (int i = tid; i < kN * kLdS; i += kThreads) state[i] = 0.f;

  const int n_tiles = L / kT;
  const int per_lane = L / 32;
  for (int row0 = 0; row0 < S; row0 += L) {
    // dt and the chunk-local cumulative sum of a
    for (int i = tid; i < L; i += kThreads) {
      dt_s[i] = dt[bh + static_cast<int64_t>(row0 + i) * H];
      cum_s[i] = a[bh + static_cast<int64_t>(row0 + i) * H];
    }
    __syncthreads();
    if (warp == 0) {
      float v[kMaxL / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        if (k < per_lane) {
          run += cum_s[lane * per_lane + k];
          v[k] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      const float before = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        if (k < per_lane) cum_s[lane * per_lane + k] = v[k] + before;
      }
    }
    __syncthreads();
    const float total = cum_s[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      rd_s[i] = to_f(from_f<T>(expf(total - cum_s[i]) * dt_s[i]));
    }
    // the operand copy of s_prev; the carried state decays by exp(total)
    // and collects this chunk's contributions tile by tile below
    const float decay_all = expf(total);
    for (int i = tid; i < kN * kP; i += kThreads) {
      const int n = i / kP;
      const int p = i - n * kP;
      const float s = state[n * kLdS + p];
      st_s[n * kLdP + p] = from_f<T>(s);
      state[n * kLdS + p] = s * decay_all;
    }
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT + warp * 16 + g;  // the thread's two rows in the chunk
      const int i1 = i0 + 8;
      const float ci0 = cum_s[i0];
      const float ci1 = cum_s[i1];
      load_tile<T, kN>(c_s, kLdN, Cg + static_cast<int64_t>(row0 + it * kT) * c_rs, c_rs, tid);

      float yacc[kP / 8][4];
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int64_t col_row = row0 + jt * kT;
        load_tile<T, kN>(b_s, kLdN, Bg + col_row * b_rs, b_rs, tid);
        load_tile<T, kP>(x_s, kLdP, xh + col_row * x_rs, x_rs, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        // scores C . B^T of the warp's 16 rows against the tile's 64 columns
        float w[kT / 8][4];
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) w[j][0] = w[j][1] = w[j][2] = w[j][3] = 0.f;
        gemm_ab1<T, kT / 8, kN>(w, c_s + warp * 16 * kLdN, kLdN, b_s, kLdN, lane);

        // weights: scores * exp(cum_i - cum_j) * dt_j where i >= j, else 0
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const int c0 = jt * kT + j * 8 + 2 * t;
          const float cj0 = cum_s[c0], cj1 = cum_s[c0 + 1];
          const float d0 = dt_s[c0], d1 = dt_s[c0 + 1];
          w[j][0] = c0 <= i0 ? w[j][0] * expf(ci0 - cj0) * d0 : 0.f;
          w[j][1] = c0 + 1 <= i0 ? w[j][1] * expf(ci0 - cj1) * d1 : 0.f;
          w[j][2] = c0 <= i1 ? w[j][2] * expf(ci1 - cj0) * d0 : 0.f;
          w[j][3] = c0 + 1 <= i1 ? w[j][3] * expf(ci1 - cj1) * d1 : 0.f;
        }
        // yacc += round_T(w) . x
        gemm_wb2<T, kP / 8, kT>(yacc, w, x_s, kLdP, wscratch, lane);

        if (jt == it) {
          // this tile's share of the state: state += B^T (x * rdec)
          __syncthreads();  // every warp has read x_s
          for (int i = tid; i < kT * kP; i += kThreads) {
            const int r = i / kP;
            const int p = i - r * kP;
            x_s[r * kLdP + p] = from_f<T>(to_f(x_s[r * kLdP + p]) * rd_s[it * kT + r]);
          }
          __syncthreads();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int m0 = warp * 32 + mt * 16;  // the warp's state rows
            float* s0 = state + (m0 + g) * kLdS + 2 * t;
            float* s1 = s0 + 8 * kLdS;
            float sacc[kP / 8][4];
#pragma unroll
            for (int j = 0; j < kP / 8; ++j) {
              sacc[j][0] = s0[j * 8];
              sacc[j][1] = s0[j * 8 + 1];
              sacc[j][2] = s1[j * 8];
              sacc[j][3] = s1[j * 8 + 1];
            }
            gemm_atb2<T, kP / 8, kT>(sacc, b_s + m0, kLdN, x_s, kLdP, lane);
#pragma unroll
            for (int j = 0; j < kP / 8; ++j) {
              s0[j * 8] = sacc[j][0];
              s0[j * 8 + 1] = sacc[j][1];
              s1[j * 8] = sacc[j][2];
              s1[j * 8 + 1] = sacc[j][3];
            }
          }
        }
        __syncthreads();  // b_s and x_s are refilled next
      }

      // inter-chunk term: exp(cum_i) * (C_i . round_T(s_prev))
      float tacc[kP / 8][4];
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;
      gemm_ab2<T, kP / 8, kN>(tacc, c_s + warp * 16 * kLdN, kLdN, st_s, kLdP, lane);
      const float e0 = expf(ci0);
      const float e1 = expf(ci1);
      float* y0 = yh + static_cast<int64_t>(row0 + i0) * y_rs + 2 * t;
      float* y1 = y0 + 8 * y_rs;
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) {
        *reinterpret_cast<float2*>(y0 + j * 8) =
            make_float2(yacc[j][0] + e0 * tacc[j][0], yacc[j][1] + e0 * tacc[j][1]);
        *reinterpret_cast<float2*>(y1 + j * 8) =
            make_float2(yacc[j][2] + e1 * tacc[j][2], yacc[j][3] + e1 * tacc[j][3]);
      }
      __syncthreads();  // c_s is refilled next; cum_s and st_s at the next chunk
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                   void* y, int batch, int S, int H, int G, int L, int64_t x_bs, int64_t x_rs,
                   int64_t b_bs, int64_t b_rs, int64_t c_bs, int64_t c_rs, cudaStream_t s) {
  constexpr int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(ssd_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_fused_kernel<T><<<dim3(H, batch), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y), S, H, G, L,
      x_bs, x_rs, b_bs, b_rs, c_bs, c_rs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers and the stream travel as
// void*; strides are in elements (batch and token strides of x, Bm and Cm;
// their head and inner strides must be headdim / dstate and 1). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ssd_fused(const void* x, const void* dt, const void* a, const void* Bm,
                         const void* Cm, void* y, int batch, int seq, int heads, int groups,
                         int headdim, int dstate, int chunk, int dtype, long long x_bs,
                         long long x_rs, long long b_bs, long long b_rs, long long c_bs,
                         long long c_rs, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || groups <= 0 || heads % groups != 0 ||
      headdim != kP || dstate != kN || chunk <= 0 || chunk > kMaxL || chunk % kT != 0 ||
      seq % chunk != 0 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch<float>(x, dt, a, Bm, Cm, y, batch, seq, heads, groups, chunk, x_bs, x_rs, b_bs,
                       b_rs, c_bs, c_rs, static_cast<cudaStream_t>(stream));
}
