// Causal / full grouped-query flash attention forward for Hopper (sm_90a),
// 16-bit inputs: wgmma fed by TMA, with warp specialisation.
//
// Replaces, for bf16 and fp16, the forward Pallas kernels of
// fms_fsdp_tpu/ops/flash_attention.py: _fwd_kernel (:62, KV resident in
// VMEM) and _fwd_kernel_kvgrid (:179, KV streamed over a grid axis). One
// kernel fulfils both contracts: no Hopper block holds a whole sequence in
// shared memory, so K/V always stream tile by tile. The fp32 forward keeps
// its scalar path in flash_attention.cu.
//
// Contract (flash_attention.cu, ops/flash_attention.py::flash_fwd): q, o
// (B, Sq, Nq, H); k, v (B, Sk, Nkv, H), contiguous, read and written in that
// layout; lse fp32 (B, Nq, Sq) in natural log. Head dim 128; Sq and Sk
// multiples of 64; query head h reads kv head h / (Nq / Nkv). Causal
// masking is top-left aligned: query i sees keys <= i, also when Sq != Sk.
//
// Numerics, the rounding points of the TPU kernel: q is scaled by scale *
// log2(e) (the constant rounded to q's dtype by the wrapper) and rounded
// back to q's dtype; the online softmax runs in base 2 in fp32; p is
// rounded to v's dtype before P.V; the products accumulate in fp32.
//
// What bounds it on the H100: tensor-core operations (each K/V tile serves
// 128 query rows: ~128 flops per byte of K/V and far more per byte of
// memory traffic once the four q heads of a kv group hit L2). What the
// design does about it, FlashAttention-3 in outline:
//   - a block owns 128 query rows of one q head: two consumer warpgroups of
//     64 rows each and one producer warpgroup; setmaxnreg moves registers
//     from the producer (40) to the consumers (232);
//   - one producer thread loads Q once and K/V tiles of 128 keys into a
//     2-stage ring with TMA (cp.async.bulk.tensor, 4-d tensor maps over the
//     unpermuted (B, S, N, H) tensors, 128-byte swizzle), completion and
//     release tracked by mbarriers; rows past the end of a sequence arrive
//     as zeros;
//   - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory;
//     the softmax runs in registers in the accumulator layout; P is rounded
//     to the input type in registers and is the register A operand of
//     O += P.V, with V read from shared memory through a transposed (MN-
//     major) descriptor: P makes no round trip through shared memory;
//   - causal blocks skip the tiles above the diagonal and mask only the
//     diagonal tile; blocks run longest rows first, and the q heads of one
//     kv group are adjacent in the launch order (grid x), so the blocks
//     that read the same K/V tiles run together and share them in L2.
// Not done yet: overlapping one tile's softmax with the next tile's S
// product inside a warpgroup, and ordering the two warpgroups' products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHead = 128;        // head dim
constexpr int kBQ = 128;          // query rows of a block
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 2;     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHalfBytes = 128 * 128;              // 128 rows x 64 elements x 2 bytes
constexpr int kTileBytes = 2 * kHalfBytes;         // 128 rows x 128 elements
constexpr int kSmemBytes = 1024 + kTileBytes * (1 + 2 * kStages) + 64;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes shared with the Python wrapper
enum DType { kBF16 = 1, kF16 = 2 };

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`; a
// wait that has not completed after ~2^34 cycles (seconds) traps, so a
// fault in the pipeline surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// one box {64 elements, 1 head, 128 rows, 1 batch} of a (B, S, N, H) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 128, fp32) (+)= A (64 x 16, shared) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d, __nv_bfloat16) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) (+)= A (64 x 16, shared) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d, __half) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, __half) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// grid (Nq, ceil(Sq / 128), B): x runs over the q heads, so the heads of a
// kv group are launched side by side; y runs the q tiles longest first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, T* __restrict__ o, float* __restrict__ lse,
    int sq, int sk, int nq, int nkv, int causal, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_k = s_q + kTileBytes;  // stage s at s_k + s * kTileBytes
  const uint32_t s_v = s_k + kStages * kTileBytes;
  const uint32_t s_bar = s_v + kStages * kTileBytes;
  // barriers: q_full, full[kStages], empty[kStages]
  const uint32_t bar_q = s_bar;
  auto bar_full = [&](int s) { return s_bar + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return s_bar + 8 * (1 + kStages + s); };

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int q0 = qt * kBQ;
  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, qt + 1);  // keys <= q0 + 127

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------ producer ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(s_q, &q_map, bar_q, 0, h, q0, b);
      tma_load(s_q + kHalfBytes, &q_map, bar_q, 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(bar_empty(s), ((kt / kStages) - 1) & 1);
        const uint32_t full = bar_full(s);
        mbar_expect_tx(full, 2 * kTileBytes);
        const uint32_t ks = s_k + s * kTileBytes;
        const uint32_t vs = s_v + s * kTileBytes;
        tma_load(ks, &k_map, full, 0, kvh, kt * kBK, b);
        tma_load(ks + kHalfBytes, &k_map, full, 64, kvh, kt * kBK, b);
        tma_load(vs, &v_map, full, 0, kvh, kt * kBK, b);
        tma_load(vs + kHalfBytes, &v_map, full, 64, kvh, kt * kBK, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wtid = tid & 127;
    const int warp = wtid >> 5;  // warp of the warpgroup: rows 16 * warp ..
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + wg * 64 + warp * 16 + g;  // the thread's two query rows
    const int r1 = r0 + 8;

    // q <- round_T(q * q_scale) over this warpgroup's 64 rows (both halves;
    // the swizzle does not matter to an elementwise map), then make the
    // generic-proxy writes visible to wgmma
    mbar_wait(bar_q, 0);
    for (int i = wtid; i < 2 * 64 * 128 / 16; i += 128) {
      const int half = i / (64 * 128 / 16);
      const int c = i - half * (64 * 128 / 16);
      uint4* p = reinterpret_cast<uint4*>(smem + half * kHalfBytes + wg * 64 * 128) + c;
      uint4 x = *p;
      T* e = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = from_f<T>(to_f(e[j]) * q_scale);
      *p = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));

    float acc[64];  // O (64 x 128): acc[4j + e], columns 8j + 2t (+1), rows g (+8)
    float s[64];    // S (64 x 128) in the same layout, keys for columns
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2), rows r0, r1
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
    const uint32_t q_rows = s_q + wg * 64 * 128;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_full(st), (kt / kStages) & 1);
      const uint32_t ks = s_k + st * kTileBytes;
      const uint32_t vs = s_v + st * kTileBytes;

      // S = Q . K^T over the 128-wide head: k steps of 16 walk 32 bytes
      // inside a 128-byte swizzled row, then the second half of the tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
        wgmma_ss(s, desc_sw128(q_rows + off, 16, 1024), desc_sw128(ks + off, 16, 1024),
                 kk > 0 ? 1 : 0, T());
      }
      wgmma_commit();
      wgmma_wait0();

      // mask the diagonal tile and keys past the end of the sequence
      const int key0 = kt * kBK;
      if ((causal && key0 + kBK - 1 > q0 + wg * 64) || key0 + kBK > sk) {
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
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        tm0 = fmaxf(tm0, fmaxf(s[4 * j], s[4 * j + 1]));
        tm1 = fmaxf(tm1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // finite: every row sees the first key of every tile it visits
      const float mn0 = fmaxf(m0, quad_max(tm0));
      const float mn1 = fmaxf(m1, quad_max(tm1));
      const float al0 = exp2f(m0 - mn0);  // first tile: exp2(-inf) = 0
      const float al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = exp2f(s[4 * j] - mn0);  // masked: exp2(-inf) = 0
        s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
        ls0 += s[4 * j] + s[4 * j + 1];
        ls1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] *= al0;
        acc[4 * j + 1] *= al0;
        acc[4 * j + 2] *= al1;
        acc[4 * j + 3] *= al1;
      }
      // P rounded to T as the A fragments of the 8 k steps (16 keys each)
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P . V: V (keys x 128) MN-major, 16 keys = 2048 bytes per k
      // step, the two 64-column halves kHalfBytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs(acc, p[kk], desc_sw128(vs + kk * 2048, kHalfBytes, 1024), T());
      }
      wgmma_commit();
      wgmma_wait0();
      if (lane == 0) mbar_arrive(bar_empty(st));
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    if (r0 < sq) {
      T* o0 = o + ((static_cast<int64_t>(b) * sq + r0) * nq + h) * kHead;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * j + 2 * t) =
            pack2<T>(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      }
      if (t == 0) lse[(static_cast<int64_t>(b) * nq + h) * sq + r0] = m0 * kLn2 + logf(l0);
    }
    if (r1 < sq) {
      T* o1 = o + ((static_cast<int64_t>(b) * sq + r1) * nq + h) * kHead;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(o1 + 8 * j + 2 * t) =
            pack2<T>(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
      if (t == 0) lse[(static_cast<int64_t>(b) * nq + h) * sq + r1] = m1 * kLn2 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime,
// so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a (B, S, N, H) tensor as a 4-d map with boxes of 64 elements x 1 head x
// 128 rows x 1 batch, 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int batch, int seq,
              int heads) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHead), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kHead) * 2,
                                 static_cast<cuuint64_t>(heads) * kHead * 2,
                                 static_cast<cuuint64_t>(seq) * heads * kHead * 2};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int sq, int sk, int nq, int nkv, int causal, float q_scale, cudaStream_t s) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, type, batch, sq, nq) || !make_map(&km, k, type, batch, sk, nkv) ||
      !make_map(&vm, v, type, batch, sk, nkv)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_sm90<T><<<dim3(nq, (sq + kBQ - 1) / kBQ, batch), kThreads, kSmemBytes, s>>>(
      qm, km, vm, static_cast<T*>(o), static_cast<float*>(lse), sq, sk, nq, nkv, causal,
      q_scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the kernel (reported by chip_smoke.py's build
// phase).
extern "C" int flash_fwd_sm90_smem_bytes() { return kSmemBytes; }

// Plain C entry point, bound with ctypes: the 16-bit forward. Pointers and
// the stream travel as void*; the return value is the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for shapes or types the
// kernel does not take or a tensor map cuTensorMapEncodeTiled refuses. q_scale is
// scale * log2(e), already rounded to the inputs' dtype.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int sq, int sk, int nq, int nkv, int head_dim,
                              int causal, int dtype, float q_scale, void* stream) {
  if (batch <= 0 || nkv <= 0 || nq % nkv != 0 || head_dim != kHead || sq <= 0 || sk <= 0 ||
      sq % 64 != 0 || sk % 64 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, o, lse, batch, sq, sk, nq, nkv, causal, q_scale, s);
    case kF16:
      return launch<__half>(q, k, v, o, lse, batch, sq, sk, nq, nkv, causal, q_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
