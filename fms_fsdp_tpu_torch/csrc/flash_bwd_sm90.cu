// Causal / full grouped-query flash attention backward for Hopper (sm_90a),
// 16-bit inputs: the dq kernel and the dk/dv kernel, wgmma fed by TMA, with
// warp specialisation.
//
// Replaces, for bf16 and fp16, the backward Pallas kernels of
// fms_fsdp_tpu/ops/flash_attention.py: _dq_kernel (:318, K/V resident in
// VMEM) and _dq_kernel_kvgrid (:368, K/V streamed over a grid axis) with
// flash_dq_kernel_sm90, and _dkv_kernel (:484) with flash_dkv_kernel_sm90.
// No Hopper block holds a whole sequence in shared memory, so the dq
// kernel always streams K/V and fulfils both dq contracts. The fp32
// backward keeps its scalar kernels in flash_attention.cu.
//
// Contract (ops/flash_attention.py::flash_dq, flash_dkv): q, dout, dq
// (B, Sq, Nq, H); k, v (B, Sk, Nkv, H); lse and delta fp32 (B, Nq, Sq), lse
// in natural log; all contiguous, read and written in that layout. dq
// comes out in q's dtype, dk and dv fp32 (B, Sk, Nkv, H), summed over the
// GQA group. Head dim 128; Sq and Sk multiples of 64; query head h reads kv
// head h / (Nq / Nkv). Causal masking is top-left aligned: query i sees
// keys <= i, also when Sq != Sk.
//
// Numerics, the rounding points of the TPU kernels: q2 = q * scale *
// log2(e) (the constant rounded to q's dtype by the wrapper) rounded back
// to q's dtype; p = exp2(q2.k - lse * log2(e)) in fp32; ds = p * (dp -
// delta) * scale in fp32; p and ds are rounded to the input type before
// their products (dV += p^T.dO, dK += ds^T.q with q unscaled, dQ +=
// ds.k); every product accumulates in fp32.
//
// What bounds both kernels on the H100: tensor-core operations (dq: three
// products of 2 * 128 flops per (query, key) pair and head element; dk/dv:
// four). The design is FlashAttention-3's backward in outline:
//   - a block has two consumer warpgroups and one producer warpgroup;
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240). One producer thread issues every load with TMA (4-d tensor
//     maps over the unpermuted (B, S, N, H) tensors, 128-byte swizzle, rows
//     past a sequence arrive as zeros) into mbarrier-tracked rings;
//   - dq: a block owns 128 query rows of one q head (64 per consumer). Q
//     and dO are loaded once, Q scaled in place as in the forward; K/V
//     tiles of 128 keys stream through a 2-stage ring. Per tile S = Q2.K^T
//     and dP = dO.V^T are wgmma m64n128k16 with both operands in shared
//     memory, issued back to back; P and dS are formed in registers in
//     the accumulator layout and dS, rounded, is the register A operand of
//     dQ += dS.K, with K read through a transposed (MN-major) descriptor;
//   - dk/dv: a block owns 128 keys of one kv head (64 per consumer, the
//     wgmma M). K and V are loaded once; for every q head of the group and
//     every 64-row query tile that reaches the block, Q, Q2, dO (TMA) and
//     the tile's lse and delta (1-d bulk copies) stream through a 3-stage
//     ring. Per tile S^T = K.Q2^T and dP^T = V.dO^T are SS m64n64k16;
//     P^T and dS^T, rounded in registers, are the A operands of dV +=
//     P^T.dO and dK += dS^T.Q (RS m64n128k16, dO and Q read MN-major).
//     dK and dV stay in registers over the whole walk and are stored once,
//     fp32, with no atomics: the result is deterministic. A key block that
//     no query reaches writes zeros; keys past Sk are not stored;
//   - causal blocks visit only the tiles that reach the diagonal and mask
//     only the diagonal tiles; a dk/dv consumer skips the products of a
//     tile whose every query precedes its keys. Blocks launch longest walk
//     first; in dq the q heads of one kv group are adjacent in the launch
//     order, so blocks that read the same K/V tiles run together and share
//     them in L2; every dk/dv block walks the query tiles from the last
//     one down, so blocks launched together read the same tiles together.
// Not done yet: overlapping one tile's elementwise work with the next
// tile's products inside a warpgroup.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kHead = 128;     // head dim
constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows (dq) or keys (dk/dv) each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;
// a tile of 128 rows x 128 elements: two 64-column halves of 16 KB
constexpr int kHalf128 = 128 * 128;
constexpr int kTile128 = 2 * kHalf128;
// a tile of 64 rows x 128 elements: two halves of 8 KB
constexpr int kHalf64 = 64 * 128;
constexpr int kTile64 = 2 * kHalf64;

// dq: 128 query rows a block, K/V tiles of 128 keys
constexpr int kDqRows = 128;
constexpr int kDqKeys = 128;
constexpr int kDqStages = 2;
// Q, dO, then the K and V rings; barriers last
constexpr int kDqSmemBytes = 1024 + kTile128 * (2 + 2 * kDqStages) + 64;

// dk/dv: 128 keys a block, query tiles of 64 rows
constexpr int kDkvKeys = 128;
constexpr int kDkvRows = 64;
constexpr int kDkvStages = 3;
constexpr int kStageBytes = 3 * kTile64;     // q, q2, dO of one tile
constexpr int kStatBytes = 2 * kDkvRows * 4;  // lse, delta of one tile
// K, V, the stages, their lse/delta; barriers last
constexpr int kDkvSmemBytes =
    1024 + 2 * kTile128 + kDkvStages * (kStageBytes + kStatBytes) + 64;

// dtype codes shared with the Python wrapper
enum DType { kBF16 = 1, kF16 = 2 };

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// grid (Nq * B, ceil(Sq / 128)): x runs over the q heads of a batch, so
// the heads of a kv group are launched side by side; y runs the query
// tiles longest first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int sq,
    int sk, int nq, int nkv, int causal, float q_scale, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_do = s_q + kTile128;
  const uint32_t s_k = s_do + kTile128;  // stage s at s_k + s * kTile128
  const uint32_t s_v = s_k + kDqStages * kTile128;
  const uint32_t s_bar = s_v + kDqStages * kTile128;
  // barriers: q/dO full, full[kDqStages], empty[kDqStages]
  const uint32_t bar_q = s_bar;
  auto bar_full = [&](int s) { return s_bar + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return s_bar + 8 * (1 + kDqStages + s); };

  const int h = blockIdx.x % nq;
  const int b = blockIdx.x / nq;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int kvh = h / (nq / nkv);
  const int q0 = qt * kDqRows;
  int n_kt = (sk + kDqKeys - 1) / kDqKeys;
  if (causal) n_kt = min(n_kt, qt + 1);  // keys <= q0 + 127

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------ producer ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, 2 * kTile128);
      tma_load(s_q, &q_map, bar_q, 0, h, q0, b);
      tma_load(s_q + kHalf128, &q_map, bar_q, 64, h, q0, b);
      tma_load(s_do, &do_map, bar_q, 0, h, q0, b);
      tma_load(s_do + kHalf128, &do_map, bar_q, 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        if (kt >= kDqStages) mbar_wait(bar_empty(s), ((kt / kDqStages) - 1) & 1);
        const uint32_t full = bar_full(s);
        mbar_expect_tx(full, 2 * kTile128);
        const uint32_t ks = s_k + s * kTile128;
        const uint32_t vs = s_v + s * kTile128;
        tma_load(ks, &k_map, full, 0, kvh, kt * kDqKeys, b);
        tma_load(ks + kHalf128, &k_map, full, 64, kvh, kt * kDqKeys, b);
        tma_load(vs, &v_map, full, 0, kvh, kt * kDqKeys, b);
        tma_load(vs + kHalf128, &v_map, full, 64, kvh, kt * kDqKeys, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = tid & 127;
    const int warp = wtid >> 5;  // warp of the warpgroup: rows 16 * warp ..
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + wg * 64 + warp * 16 + g;  // the thread's two query rows
    const int r1 = r0 + 8;
    // the rows' stats; rows past Sq (a 64-row tail) read none and are not
    // stored: their Q and dO arrive as zeros, so their values stay finite
    const int64_t stat = (static_cast<int64_t>(b) * nq + h) * sq;
    const float lse0 = r0 < sq ? lse[stat + r0] * kLog2e : 0.f;
    const float lse1 = r1 < sq ? lse[stat + r1] * kLog2e : 0.f;
    const float dl0 = r0 < sq ? delta[stat + r0] : 0.f;
    const float dl1 = r1 < sq ? delta[stat + r1] : 0.f;

    // q <- round_T(q * q_scale) over this warpgroup's 64 rows (both
    // halves), then make the generic-proxy writes visible to wgmma
    mbar_wait(bar_q, 0);
    for (int i = wtid; i < 2 * 64 * 128 / 16; i += 128) {
      const int half = i / (64 * 128 / 16);
      const int c = i - half * (64 * 128 / 16);
      uint4* p = reinterpret_cast<uint4*>(smem + half * kHalf128 + wg * 64 * 128) + c;
      uint4 x = *p;
      T* e = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = from_f<T>(to_f(e[j]) * q_scale);
      *p = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));

    float acc[64];  // dQ (64 x 128): acc[4j + e], columns 8j + 2t (+1), rows g (+8)
    float s[64];    // S, then P, then dS (64 x 128), keys for columns
    float dp[64];   // dP
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = dp[i] = 0.f;
    const uint32_t q_rows = s_q + wg * 64 * 128;
    const uint32_t do_rows = s_do + wg * 64 * 128;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kDqStages;
      mbar_wait(bar_full(st), (kt / kDqStages) & 1);
      const uint32_t ks = s_k + st * kTile128;
      const uint32_t vs = s_v + st * kTile128;

      // S = Q2 . K^T and dP = dO . V^T over the 128-wide head: k steps of
      // 16 walk 32 bytes inside a 128-byte swizzled row, then the second
      // half of the tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kHalf128 + (kk & 3) * 32;
        wgmma_ss(s, desc_sw128(q_rows + off, 16, 1024), desc_sw128(ks + off, 16, 1024),
                 kk > 0 ? 1 : 0, T());
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kHalf128 + (kk & 3) * 32;
        wgmma_ss(dp, desc_sw128(do_rows + off, 16, 1024), desc_sw128(vs + off, 16, 1024),
                 kk > 0 ? 1 : 0, T());
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is done; dP may still run

      // mask the diagonal tile and keys past the end of the sequence, then
      // P = exp2(S - lse * log2(e)) (masked: exp2(-inf) = 0)
      const int key0 = kt * kDqKeys;
      if ((causal && key0 + kDqKeys - 1 > q0 + wg * 64) || key0 + kDqKeys > sk) {
        const int lim0 = causal ? min(r0, sk - 1) : sk - 1;
        const int lim1 = causal ? min(r1, sk - 1) : sk - 1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int key = key0 + 8 * j + 2 * t;
          if (key > lim0) s[4 * j] = -INFINITY;
          if (key + 1 > lim0) s[4 * j + 1] = -INFINITY;
          if (key > lim1) s[4 * j + 2] = -INFINITY;
          if (key + 1 > lim1) s[4 * j + 3] = -INFINITY;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = exp2f(s[4 * j] - lse0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - lse0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - lse1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - lse1);
      }
      wgmma_wait<0>();  // dP is done
      // dS = P * (dP - delta) * scale, rounded to T as the A fragments of
      // the 8 k steps (16 keys each)
      uint32_t f[kDqKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int i = 8 * kk + e;
          const float dl = (e & 2) ? dl1 : dl0;  // elements 2, 3 of a quad: row g + 8
          f[kk][e / 2] = pack2<T>(s[i] * (dp[i] - dl) * scale, s[i + 1] * (dp[i + 1] - dl) * scale);
        }
      }
      // dQ += dS . K: K (keys x 128) MN-major, 16 keys = 2048 bytes per k
      // step, the two 64-column halves kHalf128 apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        wgmma_rs(acc, f[kk], desc_sw128(ks + kk * 2048, kHalf128, 1024), T());
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bar_empty(st));
    }

    if (r0 < sq) {
      T* d0 = dq + ((static_cast<int64_t>(b) * sq + r0) * nq + h) * kHead;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(d0 + 8 * j + 2 * t) = pack2<T>(acc[4 * j], acc[4 * j + 1]);
      }
    }
    if (r1 < sq) {
      T* d1 = dq + ((static_cast<int64_t>(b) * sq + r1) * nq + h) * kHead;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(d1 + 8 * j + 2 * t) =
            pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

// grid (Nkv * B, ceil(Sk / 128)): y runs the key blocks from the first,
// whose causal walk is the longest. A block walks it = 0 .. group * n_q - 1:
// query tile n_qt - 1 - it / group (the last first) of q head
// kvh * group + it % group, down to the first tile that reaches its keys.
// q2 is q scaled by scale * log2(e) and rounded to T, made once by the
// wrapper: every key block of a head reads each q tile, so scaling it here
// would repeat the work Sk / 128 times.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap q2_map,
    const __grid_constant__ CUtensorMap do_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int sq,
    int sk, int nq, int nkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_k = raw + pad;
  const uint32_t s_v = s_k + kTile128;
  const uint32_t s_st = s_v + kTile128;  // stage s: q, q2, dO at s_st + s * kStageBytes
  const uint32_t s_stat = s_st + kDkvStages * kStageBytes;  // stage s: lse, delta
  const uint32_t s_bar = s_stat + kDkvStages * kStatBytes;
  // barriers: K/V full, full[kDkvStages], empty[kDkvStages]
  const uint32_t bar_kv = s_bar;
  auto bar_full = [&](int s) { return s_bar + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return s_bar + 8 * (1 + kDkvStages + s); };

  const int kvh = blockIdx.x % nkv;
  const int b = blockIdx.x / nkv;
  const int k0 = blockIdx.y * kDkvKeys;
  const int group = nq / nkv;
  const int n_qt = sq / kDkvRows;
  const int qi_lo = causal ? min(k0 / kDkvRows, n_qt) : 0;  // first tile with a query >= k0
  const int n_it = group * (n_qt - qi_lo);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------ producer ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128 && n_it > 0) {
      mbar_expect_tx(bar_kv, 2 * kTile128);
      tma_load(s_k, &k_map, bar_kv, 0, kvh, k0, b);
      tma_load(s_k + kHalf128, &k_map, bar_kv, 64, kvh, k0, b);
      tma_load(s_v, &v_map, bar_kv, 0, kvh, k0, b);
      tma_load(s_v + kHalf128, &v_map, bar_kv, 64, kvh, k0, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kDkvStages;
        if (it >= kDkvStages) mbar_wait(bar_empty(s), ((it / kDkvStages) - 1) & 1);
        const int h = kvh * group + it % group;
        const int q0 = (n_qt - 1 - it / group) * kDkvRows;
        const uint32_t full = bar_full(s);
        mbar_expect_tx(full, kStageBytes + kStatBytes);
        const uint32_t qs = s_st + s * kStageBytes;
        tma_load(qs, &q_map, full, 0, h, q0, b);
        tma_load(qs + kHalf64, &q_map, full, 64, h, q0, b);
        tma_load(qs + kTile64, &q2_map, full, 0, h, q0, b);
        tma_load(qs + kTile64 + kHalf64, &q2_map, full, 64, h, q0, b);
        tma_load(qs + 2 * kTile64, &do_map, full, 0, h, q0, b);
        tma_load(qs + 2 * kTile64 + kHalf64, &do_map, full, 64, h, q0, b);
        const int64_t stat = (static_cast<int64_t>(b) * nq + h) * sq + q0;
        const uint32_t ss = s_stat + s * kStatBytes;
        bulk_load(ss, lse + stat, kDkvRows * 4, full);
        bulk_load(ss + kDkvRows * 4, delta + stat, kDkvRows * 4, full);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = tid & 127;
    const int warp = wtid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kw0 = k0 + wg * 64;               // the warpgroup's first key
    const int key0 = kw0 + warp * 16 + g;       // the thread's two keys (rows)
    const int key1 = key0 + 8;
    const bool live = kw0 < sk;                  // a 64-key tail past Sk: nothing to do

    float dk_acc[64];  // dK (64 keys x 128), accumulator layout
    float dv_acc[64];  // dV
    float st[32];      // S^T, then P^T, then dS^T (64 keys x 64 queries)
    float dpt[32];     // dP^T
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    const uint32_t k_rows = s_k + wg * 64 * 128;
    const uint32_t v_rows = s_v + wg * 64 * 128;
    if (n_it > 0) mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int sg = it % kDkvStages;
      mbar_wait(bar_full(sg), (it / kDkvStages) & 1);
      const int q0 = (n_qt - 1 - it / group) * kDkvRows;
      // a causal tile whose last query precedes the warpgroup's first key
      // adds nothing
      if (live && (!causal || q0 + kDkvRows - 1 >= kw0)) {
        const uint32_t qs = s_st + sg * kStageBytes;
        const uint32_t q2s = qs + kTile64;
        const uint32_t dos = qs + 2 * kTile64;
        const float* lse_s =
            reinterpret_cast<const float*>(smem + (s_stat - s_k) + sg * kStatBytes);
        const float* dl_s = lse_s + kDkvRows;

        // S^T = K . Q2^T and dP^T = V . dO^T (keys x queries), both over
        // the 128-wide head
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHead / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * kHalf128 + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * kHalf64 + (kk & 3) * 32;
          wgmma_ss(st, desc_sw128(k_rows + a_off, 16, 1024), desc_sw128(q2s + b_off, 16, 1024),
                   kk > 0 ? 1 : 0, T());
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kHead / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * kHalf128 + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * kHalf64 + (kk & 3) * 32;
          wgmma_ss(dpt, desc_sw128(v_rows + a_off, 16, 1024), desc_sw128(dos + b_off, 16, 1024),
                   kk > 0 ? 1 : 0, T());
        }
        wgmma_commit();
        wgmma_wait<1>();  // S^T is done; dP^T may still run

        // P^T = exp2(S^T - lse * log2(e)) per query column, masked where
        // the query precedes the key (the diagonal tiles only)
        const bool masked = causal && q0 < kw0 + 63;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;  // query columns c, c + 1 of the tile
          const float la = lse_s[c] * kLog2e;
          const float lb = lse_s[c + 1] * kLog2e;
          if (masked) {
            if (q0 + c < key0) st[4 * j] = -INFINITY;
            if (q0 + c + 1 < key0) st[4 * j + 1] = -INFINITY;
            if (q0 + c < key1) st[4 * j + 2] = -INFINITY;
            if (q0 + c + 1 < key1) st[4 * j + 3] = -INFINITY;
          }
          st[4 * j] = exp2f(st[4 * j] - la);
          st[4 * j + 1] = exp2f(st[4 * j + 1] - lb);
          st[4 * j + 2] = exp2f(st[4 * j + 2] - la);
          st[4 * j + 3] = exp2f(st[4 * j + 3] - lb);
        }
        // dV += round_T(P^T) . dO: dO (queries x 128) MN-major, 16 queries
        // = 2048 bytes per k step, the halves kHalf64 apart
        uint32_t pf[kDkvRows / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDkvRows / 16; ++kk) {
          pf[kk][0] = pack2<T>(st[8 * kk], st[8 * kk + 1]);
          pf[kk][1] = pack2<T>(st[8 * kk + 2], st[8 * kk + 3]);
          pf[kk][2] = pack2<T>(st[8 * kk + 4], st[8 * kk + 5]);
          pf[kk][3] = pack2<T>(st[8 * kk + 6], st[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvRows / 16; ++kk) {
          wgmma_rs(dv_acc, pf[kk], desc_sw128(dos + kk * 2048, kHalf64, 1024), T());
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done; dV may still run

        // dS^T = P^T * (dP^T - delta) * scale, rounded, then dK +=
        // round_T(dS^T) . Q (q unscaled, MN-major)
        uint32_t sf[kDkvRows / 16][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float da = dl_s[c];
          const float db = dl_s[c + 1];
          st[4 * j] = st[4 * j] * (dpt[4 * j] - da) * scale;
          st[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - db) * scale;
          st[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - da) * scale;
          st[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - db) * scale;
        }
#pragma unroll
        for (int kk = 0; kk < kDkvRows / 16; ++kk) {
          sf[kk][0] = pack2<T>(st[8 * kk], st[8 * kk + 1]);
          sf[kk][1] = pack2<T>(st[8 * kk + 2], st[8 * kk + 3]);
          sf[kk][2] = pack2<T>(st[8 * kk + 4], st[8 * kk + 5]);
          sf[kk][3] = pack2<T>(st[8 * kk + 6], st[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvRows / 16; ++kk) {
          wgmma_rs(dk_acc, sf[kk], desc_sw128(qs + kk * 2048, kHalf64, 1024), T());
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      if (lane == 0) mbar_arrive(bar_empty(sg));
    }

    // one store of each row, fp32; zeros where no query reached the keys
    const int64_t kv_stride = static_cast<int64_t>(nkv) * kHead;
    if (key0 < sk) {
      const int64_t base = ((static_cast<int64_t>(b) * sk + key0) * nkv + kvh) * kHead;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(dk + base + 8 * j + 2 * t) =
            make_float2(dk_acc[4 * j], dk_acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dv + base + 8 * j + 2 * t) =
            make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
    }
    if (key1 < sk) {
      const int64_t base = ((static_cast<int64_t>(b) * sk + key0) * nkv + kvh) * kHead + 8 * kv_stride;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(dk + base + 8 * j + 2 * t) =
            make_float2(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
        *reinterpret_cast<float2*>(dv + base + 8 * j + 2 * t) =
            make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch, int sq, int sk,
                      int nq, int nkv, int causal, float q_scale, float scale, cudaStream_t s) {
  const CUtensorMapDataType type = map_type<T>();
  CUtensorMap qm, dom, km, vm;
  if (!make_map(&qm, q, type, batch, sq, nq, kDqRows) ||
      !make_map(&dom, dout, type, batch, sq, nq, kDqRows) ||
      !make_map(&km, k, type, batch, sk, nkv, kDqKeys) ||
      !make_map(&vm, v, type, batch, sk, nkv, kDqKeys)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel_sm90<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDqSmemBytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel_sm90<T>
      <<<dim3(nq * batch, (sq + kDqRows - 1) / kDqRows), kThreads, kDqSmemBytes, s>>>(
          qm, dom, km, vm, static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), sq, sk, nq, nkv, causal, q_scale, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* q2, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int sq, int sk, int nq, int nkv, int causal, float scale,
                       cudaStream_t s) {
  const CUtensorMapDataType type = map_type<T>();
  CUtensorMap qm, q2m, dom, km, vm;
  if (!make_map(&qm, q, type, batch, sq, nq, kDkvRows) ||
      !make_map(&q2m, q2, type, batch, sq, nq, kDkvRows) ||
      !make_map(&dom, dout, type, batch, sq, nq, kDkvRows) ||
      !make_map(&km, k, type, batch, sk, nkv, kDkvKeys) ||
      !make_map(&vm, v, type, batch, sk, nkv, kDkvKeys)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel_sm90<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel_sm90<T>
      <<<dim3(nkv * batch, (sk + kDkvKeys - 1) / kDkvKeys), kThreads, kDkvSmemBytes, s>>>(
          qm, q2m, dom, km, vm, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
          sq, sk, nq, nkv, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int sq, int sk, int nq, int nkv, int head_dim) {
  return batch <= 0 || nkv <= 0 || nq % nkv != 0 || head_dim != kHead || sq <= 0 || sk <= 0 ||
         sq % 64 != 0 || sk % 64 != 0;
}

}  // namespace

// Dynamic shared memory of the dq kernel (which == 0) or the dk/dv kernel
// (which == 1), reported by chip_smoke.py's build phase.
extern "C" int flash_bwd_sm90_smem_bytes(int which) {
  return which == 0 ? kDqSmemBytes : kDkvSmemBytes;
}

// Plain C entry points, bound with ctypes, with the arguments of flash_dq
// and flash_dkv in flash_attention.cu. Pointers and the stream travel as
// void*; each returns the cudaError_t of its launch (0 on success),
// cudaErrorInvalidValue for shapes or types the kernels do not take or a
// tensor map cuTensorMapEncodeTiled refuses. q_scale is scale * log2(e),
// already rounded to the inputs' dtype; scale is the softmax scale in fp32;
// flash_dkv_sm90 takes q already scaled (q2) beside q.
extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int batch, int sq,
                             int sk, int nq, int nkv, int head_dim, int causal, int dtype,
                             float q_scale, float scale, void* stream) {
  if (bad_shape(batch, sq, sk, nq, nkv, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, batch, sq, sk, nq, nkv,
                                      causal, q_scale, scale, s);
    case kF16:
      return launch_dq<__half>(q, k, v, dout, lse, delta, dq, batch, sq, sk, nq, nkv, causal,
                               q_scale, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int flash_dkv_sm90(const void* q, const void* q2, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta, void* dk,
                              void* dv, int batch, int sq, int sk, int nq, int nkv, int head_dim,
                              int causal, int dtype, float scale, void* stream) {
  if (bad_shape(batch, sq, sk, nq, nkv, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch_dkv<__nv_bfloat16>(q, q2, k, v, dout, lse, delta, dk, dv, batch, sq, sk, nq,
                                       nkv, causal, scale, s);
    case kF16:
      return launch_dkv<__half>(q, q2, k, v, dout, lse, delta, dk, dv, batch, sq, sk, nq, nkv,
                                causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
