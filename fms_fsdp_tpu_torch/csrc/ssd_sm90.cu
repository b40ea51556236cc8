// Fused whole-sequence Mamba2 SSD (state-space dual) scan for Hopper
// (sm_90a), forward, 16-bit inputs (bf16 and fp16). fp32 inputs keep the
// kernel of ssd.cu.
//
// Replaces, for bf16 and fp16, the Pallas kernel
// fms_fsdp_tpu/ops/ssd.py:51 `_fused_kernel` (call :186). The math, the
// layout and the entry point's arguments are those of ssd.cu: per chunk of
// L tokens of one head
//
//   cum_i = sum(a[0..i])                (chunk-local, fp32)
//   w_ij  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y_i   = sum_j round_T(w_ij) x_j + exp(cum_i) * (C_i . round_T(s_prev))
//   s_new = exp(cum_L-1) * s_prev
//           + sum_l B_l^T round_T(x_l * round_T(exp(cum_L-1 - cum_l) * dt_l))
//
// with s (N, P) fp32 carried from chunk to chunk, every product summed in
// fp32 and the casts to T where the TPU kernel makes them. x (B, S, H, P)
// and Bm/Cm (B, S, G, N) are read through their batch and token strides;
// dt, a = dt * A (B, S, H) fp32 contiguous; y (B, S, H, P) fp32, no D term.
// P = 64, N = 128, L a multiple of 64 up to 256, S a multiple of L.
//
// What bounds it on the H100: bytes. At B=2, S=4096, H=128, G=1, L=256 the
// operands are 0.41 GB (the fp32 y alone 268 MB), 0.124 ms at 3.35 TB/s,
// against 69 GFLOP of the chunked algorithm. The kernel of ssd.cu reached
// 14% of that bound: every pair of 64-token tiles waited for its own loads,
// B and x were read once per tile pair, every head recomputed C.B^T, and
// the fp32 state lived in shared memory. This design, still with mma.sync
// m16n8k16 fed by ldmatrix and cp.async (no wgmma, no TMA):
//
//   (a) One read of each tile. A block walks a chunk's 64-token row tiles
//       in order and keeps the chunk's B and x tiles resident as they
//       arrive: tile t's B and x stay in slot t of a ring of L / 64 slots,
//       so row tile i finds every column tile j <= i already in shared
//       memory. C is needed by its own row tile only (two slots). Every
//       byte of x, B and C is read from device memory once per block.
//   (b) Loads in flight during the products. Row tile t issues the loads
//       of tile t + 1 (C, B, x of its heads) before its products and waits
//       for them after its state update. The last row tile of a chunk
//       issues the next chunk's first tile, dt and a once every warp is
//       past its products, and adds its own tile to the state while they
//       fly: one wait a chunk with nothing but that state update ahead.
//   (c) Warps and grid. A block carries HB heads of one group (HB = 2 when
//       H / G is even, else 1) with four warps per head: at the training
//       shape 8 warps per SM, and a grid of (H / 2) x B = 128 blocks, one
//       wave over 128 of the 132 SMs.
//   (d) C.B^T once for the block's heads. Warp (head hh, row group r)
//       computes rows 16r .. 16r + 15 of the 64 x 64 score tile of a (row
//       tile, column tile) pair, columns 32hh .. 32hh + 31, and the two
//       warps of a row group swap halves through an fp32 tile in shared
//       memory (two block barriers a tile pair; a barrier of the two warps
//       alone measured no faster). Each warp applies
//       its head's exp(cum_i - cum_j) * dt_j. Below the diagonal tile the
//       exponential splits at the column tile's last token e,
//       exp(cum_i - cum_e) * exp(cum_e - cum_j), both factors at most 1:
//       two exponentials a row a tile, the column factors (times dt) once
//       a chunk. One exponential a weight took about a quarter of the
//       kernel's time on an H100.
//   (e) The carried state in registers. Each head's four warps hold its
//       fp32 (N, P) state in the mma accumulator layout (32 rows of N a
//       warp, 64 registers a thread) and add each tile's B^T (x * rd) in
//       place after the row tile's y is stored, with the x fragments scaled
//       by rd and rounded to T in registers. Once per chunk it is written
//       to shared memory, rounded to T, as the operand of C . s_prev, then
//       decayed in place. It fits without a spill (PERF.md gives ptxas's
//       registers) because the tile loads are rolled loops: unrolled, their
//       per-thread addresses stayed live and spilled.
//
// Shared memory at HB = 2, L = 256: B 4 x 16 KB, x 4 x 2 x 8 KB, C 2 x 16
// KB, round_T(s_prev) 2 x 16 KB, the fp32 score tile 18 KB, dt/a for two
// chunks, rd and the column factors 12 KB: 227,328 bytes, one block per
// SM. The 16-bit tiles are unpadded with their 16-byte chunks
// XOR-swizzled by row (padding would not fit), so ldmatrix and cp.async
// meet no bank conflicts.
//
// What is left: mma.sync fragments are re-read from shared memory by every
// warp (a 16-row tile per warp), and the row groups' products wait on the
// exponentials before them. wgmma (64-row tiles, B straight from shared
// memory) and TMA are the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kP = 64;       // head dim
constexpr int kN = 128;      // state dim
constexpr int kT = 64;       // tokens of a tile
constexpr int kMaxL = 256;   // longest chunk
constexpr int kLdScore = 72; // row stride of the fp32 score tile (floats)

enum DType { kBF16 = 1, kF16 = 2 };  // dtype codes of the Python wrapper

// element offset of (row, col) in a tile of kCols 16-bit elements per row,
// whose 16-byte chunks are XOR-swizzled by row % 8; col a multiple of 8 or
// any col inside the chunk
template <int kCols>
__device__ __forceinline__ int sw(int row, int col) {
  return row * kCols + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}
// the same as a byte offset
template <int kCols>
__device__ __forceinline__ uint32_t swb(int row, int col) {
  return 2u * static_cast<uint32_t>(sw<kCols>(row, col));
}

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// ldmatrix x4 from a shared-memory address (see common.cuh)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}


__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// kT rows of kCols elements, row r from g + r * stride, into a swizzled tile
template <typename T, int kCols, int kThreads>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g, int64_t stride,
                                          int tid) {
  constexpr int kChunks = kCols / 8;
  // rolled: unrolled, the per-thread addresses would stay live in registers
#pragma unroll 1
  for (int c = tid; c < kT * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    cp_async16(sm + sw<kCols>(r, col), g + r * stride + col);
  }
}

// The products share the accumulator layout of mma m16n8k16: acc[j] of a
// warp's 16 x 8NT tile holds rows g and g + 8, columns 8j + 2t and 8j + 2t
// + 1 (g = lane / 4, t = lane % 4).

// acc += A B1: A the 16 rows of a swizzled (kCols-wide) tile from row a0,
// B1(k, n) = row n0 + n, column k of a swizzled tile (the product runs
// against its rows); K = kCols
template <typename T, int NT, int kCols>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[NT][4], uint32_t As, int a0,
                                              uint32_t Bs, int n0, int lane) {
  static_assert(NT % 2 == 0, "n tiles come in pairs");
  const int ar = a0 + (lane & 15);
  const int ac = 8 * (lane >> 4);
  const int br = n0 + (lane & 7) + 8 * (lane >> 4);
  const int bc = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < kCols; kk += 16) {
    uint32_t a[4];
    ldsm4(a, As + swb<kCols>(ar, kk + ac));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, Bs + swb<kCols>(br + j * 8, kk + bc));
      mma16816<T>(acc[j], a, b[0], b[1]);
      mma16816<T>(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 64) += A B2: A as in mma_rows_rows (K = kCols columns),
// B2(k, n) = row k, column n of a swizzled 64-wide tile
template <typename T, int kCols>
__device__ __forceinline__ void mma_rows_cols(float (&acc)[8][4], uint32_t As, int a0,
                                              uint32_t Bs, int lane) {
  const int ar = a0 + (lane & 15);
  const int ac = 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kCols; kk += 16) {
    uint32_t a[4];
    ldsm4(a, As + swb<kCols>(ar, kk + ac));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldsm4t(b, Bs + swb<kP>(kk + (lane & 15), (j + (lane >> 4)) * 8));
      mma16816<T>(acc[j], a, b[0], b[1]);
      mma16816<T>(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T lo_of(uint32_t v);
template <>
__device__ __forceinline__ __nv_bfloat16 lo_of<__nv_bfloat16>(uint32_t v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xffffu));
}
template <>
__device__ __forceinline__ __half lo_of<__half>(uint32_t v) {
  return __ushort_as_half(static_cast<unsigned short>(v & 0xffffu));
}

// a packed pair of T values, each times its own fp32 factor, rounded to T
template <typename T>
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  return pack2<T>(to_f(lo_of<T>(v)) * lo, to_f(lo_of<T>(v >> 16)) * hi);
}

// state (rows m0 .. m0 + 31 of N, all 64 of P) += B^T X~, with A(m, k) =
// row k, column m of the swizzled B tile (kN wide) and X~(k, n) =
// round_T(x(k, n) * rd[k]) from the swizzled x tile, scaled in registers
template <typename T>
__device__ __forceinline__ void mma_state(float (&s)[2][8][4], uint32_t Bs, int m0,
                                          uint32_t Xs, const float* rd, int lane) {
  const int t = lane & 3;
  const int ar = (lane & 7) + 8 * (lane >> 4);
  const int ac = m0 + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    uint32_t a0[4], a1[4];
    ldsm4t(a0, Bs + swb<kN>(kk + ar, ac));
    ldsm4t(a1, Bs + swb<kN>(kk + ar, ac + 16));
    // the rd factors of this thread's fragment rows: k = kk + 2t, + 1, + 8, + 9
    const float2 r0 = *reinterpret_cast<const float2*>(rd + kk + 2 * t);
    const float2 r1 = *reinterpret_cast<const float2*>(rd + kk + 8 + 2 * t);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldsm4t(b, Xs + swb<kP>(kk + (lane & 15), (j + (lane >> 4)) * 8));
      b[0] = scale2<T>(b[0], r0.x, r0.y);
      b[1] = scale2<T>(b[1], r1.x, r1.y);
      b[2] = scale2<T>(b[2], r0.x, r0.y);
      b[3] = scale2<T>(b[3], r1.x, r1.y);
      mma16816<T>(s[0][j], a0, b[0], b[1]);
      mma16816<T>(s[0][j + 1], a0, b[2], b[3]);
      mma16816<T>(s[1][j], a1, b[0], b[1]);
      mma16816<T>(s[1][j + 1], a1, b[2], b[3]);
    }
  }
}

// dynamic shared memory of a block: B and x rings of L / 64 slots, two C
// slots, round_T(s_prev) of each head, the fp32 score tile, dt and a of
// two chunks, rd and the column factors
__host__ __device__ constexpr int smem_bytes(int hb, int L) {
  return 2 * (L * (kN + hb * kP) + 2 * kT * kN + hb * kN * kP) +
         4 * (kT * kLdScore + 6 * hb * L);
}

// grid (H / HB, B): one block per HB heads of one group and one batch row,
// the chunk sweep inside it; 128 * HB threads, warp w works for head w / 4
template <typename T, int HB>
__global__ void __launch_bounds__(128 * HB, 1) ssd_fused_sm90_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y, int S, int H,
    int G, int L, int64_t x_bs, int64_t x_rs, int64_t b_bs, int64_t b_rs, int64_t c_bs,
    int64_t c_rs) {
  constexpr int kThreads = 128 * HB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = L / kT;
  T* b_ring = reinterpret_cast<T*>(smem);  // [nt][kT x kN]
  T* x_ring = b_ring + L * kN;             // [nt][HB][kT x kP]
  T* c_ring = x_ring + L * HB * kP;        // [2][kT x kN]
  T* st_s = c_ring + 2 * kT * kN;          // [HB][kN x kP], round_T(s_prev)
  float* score = reinterpret_cast<float*>(st_s + HB * kN * kP);  // kT x kLdScore
  float* dta = score + kT * kLdScore;      // [2 chunks][dt, a -> cum][HB][L]
  float* rd_s = dta + 4 * HB * L;          // [HB][L]
  float* cd_s = rd_s + HB * L;             // [HB][L]
  const uint32_t b_ring_u = su32(b_ring);  // the same, as shared-memory addresses
  const uint32_t x_ring_u = su32(x_ring);
  const uint32_t c_ring_u = su32(c_ring);
  const uint32_t st_u = su32(st_s);

  const int h0 = blockIdx.x * HB;
  const int b = blockIdx.y;
  const int grp = h0 / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hh = warp >> 2;  // the warp's head in the block
  const int r = warp & 3;    // its 16 rows of a row tile, its 32 rows of the state

  const T* xb = x + b * x_bs + static_cast<int64_t>(h0) * kP;
  const T* Bg = Bm + b * b_bs + static_cast<int64_t>(grp) * kN;
  const T* Cg = Cm + b * c_bs + static_cast<int64_t>(grp) * kN;
  const int64_t tok0 = static_cast<int64_t>(b) * S;  // dt, a, y: (tok0 + token) * H + head

  // C, B and the heads' x of the 64 tokens from `row` into slot `slot` of
  // the B and x rings and slot `cslot` of C
  auto issue_tile = [&](int row, int slot, int cslot) {
    load_tile<T, kN, kThreads>(b_ring + slot * kT * kN, Bg + row * b_rs, b_rs, tid);
    load_tile<T, kN, kThreads>(c_ring + cslot * kT * kN, Cg + row * c_rs, c_rs, tid);
#pragma unroll 1
    for (int c = tid; c < kT * HB * 8; c += kThreads) {
      const int rr = c / (HB * 8);
      const int head = (c >> 3) % HB;
      const int col = (c & 7) * 8;
      cp_async16(x_ring + (slot * HB + head) * kT * kP + sw<kP>(rr, col),
                 xb + (row + rr) * x_rs + head * kP + col);
    }
  };
  // dt and a of the L tokens from `row` into the buffers of chunk parity par
  auto issue_dta = [&](int row, int par) {
    float* d = dta + par * 2 * HB * L;
#pragma unroll 1
    for (int i = tid; i < 2 * HB * L; i += kThreads) {
      const int head = i % HB;  // heads fastest: neighbouring addresses
      const int k = (i / HB) % L;
      const int arr = i / (HB * L);
      cp_async4(d + (arr * HB + head) * L + k,
                (arr ? a : dt) + (tok0 + row + k) * H + h0 + head);
    }
  };

  float st[2][8][4];  // the carried state, rows r * 32 + 16 mt (+ g, + 8) of N
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) st[mt][j][0] = st[mt][j][1] = st[mt][j][2] = st[mt][j][3] = 0.f;

  issue_dta(0, 0);
  issue_tile(0, 0, 0);
  cp_async_commit();
  int cs = 0;  // the C slot of the current row tile
  for (int chunk = 0, row0 = 0; row0 < S; ++chunk, row0 += L) {
    float* dt_c = dta + (chunk & 1) * 2 * HB * L;
    float* cum_c = dt_c + HB * L;
    cp_async_wait<0>();  // this chunk's first tile, dt and a
    __syncthreads();
    if (r == 0) {
      // the chunk-local inclusive cumsum of a, in place, one warp a head
      float* cw = cum_c + hh * L;
      const int per_lane = L / 32;
      float v[kMaxL / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        if (k < per_lane) {
          run += cw[lane * per_lane + k];
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
        if (k < per_lane) cw[lane * per_lane + k] = v[k] + before;
      }
    }
    __syncthreads();
    for (int i = tid; i < HB * L; i += kThreads) {
      const float* cum_i = cum_c + (i / L) * L;
      const int k = i % L;
      rd_s[i] = to_f(from_f<T>(expf(cum_i[L - 1] - cum_c[i]) * dt_c[i]));
      // the column factor of the weights below the diagonal tiles
      cd_s[i] = expf(cum_i[(k | (kT - 1))] - cum_c[i]) * dt_c[i];
    }
    const float* cum_h = cum_c + hh * L;
    const float* dt_h = dt_c + hh * L;
    const float* rd_h = rd_s + hh * L;
    const float* cd_h = cd_s + hh * L;
    {
      // round_T(s_prev), the operand of C . s_prev; then the decay of the
      // carried state by exp(total), to which the tiles below add
      T* st_h = st_s + hh * kN * kP;
      const float decay = expf(cum_h[L - 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = r * 32 + mt * 16 + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(st_h + sw<kP>(row, j * 8 + 2 * t)) =
              pack2<T>(st[mt][j][0], st[mt][j][1]);
          *reinterpret_cast<uint32_t*>(st_h + sw<kP>(row + 8, j * 8 + 2 * t)) =
              pack2<T>(st[mt][j][2], st[mt][j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][j][e] *= decay;
        }
      }
    }
    __syncthreads();

    for (int it = 0; it < nt; ++it) {
      if (it + 1 < nt) {
        issue_tile(row0 + (it + 1) * kT, it + 1, cs ^ 1);
        cp_async_commit();
      }
      const uint32_t c_t = c_ring_u + cs * (kT * kN * 2);
      const int i0 = it * kT + r * 16 + g;  // the thread's two rows in the chunk
      const int i1 = i0 + 8;
      const float ci0 = cum_h[i0];
      const float ci1 = cum_h[i1];

      // inter-chunk term first: exp(cum_i) * (C_i . round_T(s_prev))
      float yacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
      if (chunk > 0) {
        mma_rows_cols<T, kN>(yacc, c_t, r * 16, st_u + hh * (kN * kP * 2), lane);
        const float e0 = expf(ci0);
        const float e1 = expf(ci1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          yacc[j][0] *= e0;
          yacc[j][1] *= e0;
          yacc[j][2] *= e1;
          yacc[j][3] *= e1;
        }
      }

      for (int jt = 0; jt <= it; ++jt) {
        const uint32_t b_j = b_ring_u + jt * (kT * kN * 2);
        const uint32_t x_j = x_ring_u + (jt * HB + hh) * (kT * kP * 2);
        // the score tile C . B^T, once for the block's heads. With two
        // heads, warp (hh, r) computes rows r * 16 .. + 15, columns hh * 32
        // .. + 31, and the two warps of row group r exchange their halves
        // through shared memory; with one head each warp computes its 16
        // rows whole and keeps them in registers
        float sacc[3 - HB][4][4];
#pragma unroll
        for (int q = 0; q < 3 - HB; ++q) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[q][j][0] = sacc[q][j][1] = sacc[q][j][2] = sacc[q][j][3] = 0.f;
          mma_rows_rows<T, 4, kN>(sacc[q], c_t, r * 16, b_j, (HB == 2 ? hh : q) * 32, lane);
        }
        if constexpr (HB == 2) {
          __syncthreads();  // every warp is done with the last score tile
          float* s0 = score + (r * 16 + g) * kLdScore + hh * 32 + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<float2*>(s0 + j * 8) = make_float2(sacc[0][j][0], sacc[0][j][1]);
            *reinterpret_cast<float2*>(s0 + j * 8 + 8 * kLdScore) =
                make_float2(sacc[0][j][2], sacc[0][j][3]);
          }
          __syncthreads();  // both halves of every row group are in place
        }
        // the scores of rows g and g + 8 of the warp, columns col, col + 1
        auto score_pair = [&](int col, float2& u, float2& v) {
          if constexpr (HB == 2) {
            const float* s0 = score + (r * 16 + g) * kLdScore + col;
            u = *reinterpret_cast<const float2*>(s0);
            v = *reinterpret_cast<const float2*>(s0 + 8 * kLdScore);
          } else {
            const float* a4 = sacc[col >> 5][(col >> 3) & 3];
            u = make_float2(a4[0], a4[1]);
            v = make_float2(a4[2], a4[3]);
          }
        };

        // yacc += round_T(w) . x, 16 columns of w at a time: this head's
        // weights, scores * exp(cum_i - cum_j) * dt_j where i >= j, else 0,
        // packed straight into A fragments. Below the diagonal tile the
        // exponential splits at the column tile's last token e, exp(cum_i -
        // cum_e) * exp(cum_e - cum_j), both factors at most 1: two
        // exponentials a row and the column factors (times dt) of cd_h
        // instead of one exponential a weight
        const bool diag = jt == it;
        float rf0 = 0.f, rf1 = 0.f;
        if (!diag) {
          const float ce = cum_h[jt * kT + kT - 1];
          rf0 = expf(ci0 - ce);
          rf1 = expf(ci1 - ce);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = kk * 16 + q * 8 + 2 * t;
            float2 u, v;
            score_pair(col, u, v);
            const int c0 = jt * kT + col;
            if (diag) {
              const float cj0 = cum_h[c0], cj1 = cum_h[c0 + 1];
              const float d0 = dt_h[c0], d1 = dt_h[c0 + 1];
              w[q][0] = c0 <= i0 ? u.x * expf(ci0 - cj0) * d0 : 0.f;
              w[q][1] = c0 + 1 <= i0 ? u.y * expf(ci0 - cj1) * d1 : 0.f;
              w[q][2] = c0 <= i1 ? v.x * expf(ci1 - cj0) * d0 : 0.f;
              w[q][3] = c0 + 1 <= i1 ? v.y * expf(ci1 - cj1) * d1 : 0.f;
            } else {
              const float2 cd = *reinterpret_cast<const float2*>(cd_h + c0);
              w[q][0] = u.x * rf0 * cd.x;
              w[q][1] = u.y * rf0 * cd.y;
              w[q][2] = v.x * rf1 * cd.x;
              w[q][3] = v.y * rf1 * cd.y;
            }
          }
          uint32_t af[4];
          af[0] = pack2<T>(w[0][0], w[0][1]);
          af[1] = pack2<T>(w[0][2], w[0][3]);
          af[2] = pack2<T>(w[1][0], w[1][1]);
          af[3] = pack2<T>(w[1][2], w[1][3]);
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            uint32_t bf[4];
            ldsm4t(bf, x_j + swb<kP>(kk * 16 + (lane & 15), (j + (lane >> 4)) * 8));
            mma16816<T>(yacc[j], af, bf[0], bf[1]);
            mma16816<T>(yacc[j + 1], af, bf[2], bf[3]);
          }
        }
      }

      float* y0 = y + ((tok0 + row0 + i0) * H + h0 + hh) * kP + 2 * t;
      float* y1 = y0 + static_cast<int64_t>(8) * H * kP;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(y0 + j * 8) = make_float2(yacc[j][0], yacc[j][1]);
        *reinterpret_cast<float2*>(y1 + j * 8) = make_float2(yacc[j][2], yacc[j][3]);
      }

      // this tile's share of the state, once yacc is stored: state += B^T
      // round_T(x * rd), while the loads of the next tile are in flight
      auto add_tile_to_state = [&]() {
        mma_state<T>(st, b_ring_u + it * (kT * kN * 2), r * 32,
                     x_ring_u + (it * HB + hh) * (kT * kP * 2), rd_h + it * kT, lane);
      };
      if (it + 1 < nt) {
        add_tile_to_state();
        cp_async_wait<0>();  // tile it + 1
        __syncthreads();     // ... for every warp; every warp is done with C slot cs
      } else {
        if (nt == 1) add_tile_to_state();  // it reads slot 0, refilled below
        if (row0 + L < S) {
          __syncthreads();  // every warp is done with slot 0 and C slot cs ^ 1
          issue_dta(row0 + L, (chunk + 1) & 1);
          issue_tile(row0 + L, 0, cs ^ 1);
          cp_async_commit();
        }
        if (nt > 1) add_tile_to_state();  // slot nt - 1, under the loads
      }
      cs ^= 1;
    }
  }
}

template <typename T, int HB>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                   void* y, int batch, int S, int H, int G, int L, int64_t x_bs, int64_t x_rs,
                   int64_t b_bs, int64_t b_rs, int64_t c_bs, int64_t c_rs, cudaStream_t s) {
  const int bytes = smem_bytes(HB, L);
  cudaError_t err = cudaFuncSetAttribute(ssd_fused_sm90_kernel<T, HB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_fused_sm90_kernel<T, HB><<<dim3(H / HB, batch), 128 * HB, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y), S, H, G, L,
      x_bs, x_rs, b_bs, b_rs, c_bs, c_rs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_heads(int heads_per_block, const void* x, const void* dt, const void* a,
                         const void* Bm, const void* Cm, void* y, int batch, int S, int H,
                         int G, int L, int64_t x_bs, int64_t x_rs, int64_t b_bs, int64_t b_rs,
                         int64_t c_bs, int64_t c_rs, cudaStream_t s) {
  if (heads_per_block == 2)
    return launch<T, 2>(x, dt, a, Bm, Cm, y, batch, S, H, G, L, x_bs, x_rs, b_bs, b_rs, c_bs,
                        c_rs, s);
  return launch<T, 1>(x, dt, a, Bm, Cm, y, batch, S, H, G, L, x_bs, x_rs, b_bs, b_rs, c_bs,
                      c_rs, s);
}

}  // namespace

// Plain C entry point, bound with ctypes; the arguments of ssd.cu's
// ssd_fused (strides in elements, the dtype code 1 bf16 or 2 fp16).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_fused_sm90(const void* x, const void* dt, const void* a, const void* Bm,
                              const void* Cm, void* y, int batch, int seq, int heads, int groups,
                              int headdim, int dstate, int chunk, int dtype, long long x_bs,
                              long long x_rs, long long b_bs, long long b_rs, long long c_bs,
                              long long c_rs, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || groups <= 0 || heads % groups != 0 ||
      headdim != kP || dstate != kN || chunk <= 0 || chunk > kMaxL || chunk % kT != 0 ||
      seq % chunk != 0 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  // two heads of one group a block where the group's heads pair up
  const int hb = (heads / groups) % 2 == 0 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch_heads<__nv_bfloat16>(hb, x, dt, a, Bm, Cm, y, batch, seq, heads, groups,
                                         chunk, x_bs, x_rs, b_bs, b_rs, c_bs, c_rs, s);
    case kF16:
      return launch_heads<__half>(hb, x, dt, a, Bm, Cm, y, batch, seq, heads, groups, chunk,
                                  x_bs, x_rs, b_bs, b_rs, c_bs, c_rs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of a launch with `heads_per_block` heads and chunk L
extern "C" int ssd_sm90_smem_bytes(int heads_per_block, int chunk) {
  return smem_bytes(heads_per_block, chunk);
}
