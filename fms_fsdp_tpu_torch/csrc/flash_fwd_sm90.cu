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
//   - one producer thread loads Q once and K/V tiles of kBK keys into a
//     ring with TMA (cp.async.bulk.tensor, 4-d tensor maps over the
//     unpermuted (B, S, N, H) tensors, 128-byte swizzle), completion and
//     release tracked by mbarriers; rows past the end of a sequence arrive
//     as zeros. The key tile is a template parameter, 128 or 64 (the
//     tuning table picks it, tune/candidates.py): 128-key tiles in a
//     2-stage ring, 64-key tiles in a 4-stage ring, the same bytes in
//     flight;
//   - S = Q.K^T is wgmma m64n128k16 (m64n64k16 at 64 keys) with both
//     operands in shared memory;
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
#include "sm90.cuh"

namespace {

constexpr int kHead = 128;        // head dim
constexpr int kBQ = 128;          // query rows of a block
constexpr int kConsumers = 2;     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHalfBytes = 128 * 128;              // 128 rows x 64 elements x 2 bytes
constexpr int kTileBytes = 2 * kHalfBytes;         // 128 rows x 128 elements
constexpr float kLn2 = 0.6931471805599453f;

// a key tile of kBK keys: K/V ring depth, the bytes of one 64-column half
// and of the tile, the barriers (q, then full and empty a stage) in whole
// 64-byte lines, and the block's dynamic shared memory (the 1024-byte
// swizzle alignment, Q, the K and V rings, the barriers)
template <int kBK>
struct KeyTile {
  static_assert(kBK == 64 || kBK == 128, "key tiles of 64 or 128");
  static constexpr int kStages = kBK == 64 ? 4 : 2;
  static constexpr int kHalf = kBK * 128;
  static constexpr int kTile = 2 * kHalf;
  static constexpr int kBarBytes = 64 * ((8 * (1 + 2 * kStages) + 63) / 64);
  static constexpr int kSmemBytes = 1024 + kTileBytes + 2 * kStages * kTile + kBarBytes;
};

// dtype codes shared with the Python wrapper
enum DType { kBF16 = 1, kF16 = 2 };

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// grid (Nq, ceil(Sq / 128), B): x runs over the q heads, so the heads of a
// kv group are launched side by side; y runs the q tiles longest first.
template <typename T, int kBK>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, T* __restrict__ o, float* __restrict__ lse,
    int sq, int sk, int nq, int nkv, int causal, float q_scale) {
  using KT = KeyTile<kBK>;
  constexpr int kStages = KT::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_k = s_q + kTileBytes;  // stage s at s_k + s * KT::kTile
  const uint32_t s_v = s_k + kStages * KT::kTile;
  const uint32_t s_bar = s_v + kStages * KT::kTile;
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
  if (causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);  // keys <= q0 + 127

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
        mbar_expect_tx(full, 2 * KT::kTile);
        const uint32_t ks = s_k + s * KT::kTile;
        const uint32_t vs = s_v + s * KT::kTile;
        tma_load(ks, &k_map, full, 0, kvh, kt * kBK, b);
        tma_load(ks + KT::kHalf, &k_map, full, 64, kvh, kt * kBK, b);
        tma_load(vs, &v_map, full, 0, kvh, kt * kBK, b);
        tma_load(vs + KT::kHalf, &v_map, full, 64, kvh, kt * kBK, b);
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

    constexpr int kJ = kBK / 8;  // 8-column groups of S
    float acc[64];   // O (64 x 128): acc[4j + e], columns 8j + 2t (+1), rows g (+8)
    float s[kBK / 2];  // S (64 x kBK) in the same layout, keys for columns
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2), rows r0, r1
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
    const uint32_t q_rows = s_q + wg * 64 * 128;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_full(st), (kt / kStages) & 1);
      const uint32_t ks = s_k + st * KT::kTile;
      const uint32_t vs = s_v + st * KT::kTile;

      // S = Q . K^T over the 128-wide head: k steps of 16 walk 32 bytes
      // inside a 128-byte swizzled row, then the second half of each tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        const uint32_t in_row = (kk & 3) * 32;
        wgmma_ss(s, desc_sw128(q_rows + (kk >> 2) * kHalfBytes + in_row, 16, 1024),
                 desc_sw128(ks + (kk >> 2) * KT::kHalf + in_row, 16, 1024), kk > 0 ? 1 : 0,
                 T());
      }
      wgmma_commit();
      wgmma_wait0();

      // mask the diagonal tiles (one at 128 keys, two at 64: the one that
      // crosses this warpgroup's rows and, for the first warpgroup, the
      // next, which its rows do not reach) and keys past the sequence
      const int key0 = kt * kBK;
      if ((causal && key0 + kBK - 1 > q0 + wg * 64) || key0 + kBK > sk) {
        const int lim0 = causal ? min(r0, sk - 1) : sk - 1;
        const int lim1 = causal ? min(r1, sk - 1) : sk - 1;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int key = key0 + 8 * j + 2 * t;
          if (key > lim0) s[4 * j] = -INFINITY;
          if (key + 1 > lim0) s[4 * j + 1] = -INFINITY;
          if (key > lim1) s[4 * j + 2] = -INFINITY;
          if (key + 1 > lim1) s[4 * j + 3] = -INFINITY;
        }
      }
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        tm0 = fmaxf(tm0, fmaxf(s[4 * j], s[4 * j + 1]));
        tm1 = fmaxf(tm1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // finite: every row sees key 0 in the first tile, and a later tile
      // its rows do not reach (a 64-key tile past the first warpgroup's
      // rows) leaves the running max as it was
      const float mn0 = fmaxf(m0, quad_max(tm0));
      const float mn1 = fmaxf(m1, quad_max(tm1));
      const float al0 = exp2f(m0 - mn0);  // first tile: exp2(-inf) = 0
      const float al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
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
      // P rounded to T as the A fragments of the kBK / 16 k steps (16 keys
      // each)
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P . V: V (keys x 128) MN-major, 16 keys = 2048 bytes per k
      // step, the two 64-column halves KT::kHalf apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs(acc, p[kk], desc_sw128(vs + kk * 2048, KT::kHalf, 1024), T());
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

template <typename T, int kBK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int sq, int sk, int nq, int nkv, int causal, float q_scale, cudaStream_t s) {
  constexpr int kSmemBytes = KeyTile<kBK>::kSmemBytes;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, type, batch, sq, nq, kBQ) || !make_map(&km, k, type, batch, sk, nkv, kBK) ||
      !make_map(&vm, v, type, batch, sk, nkv, kBK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<T, kBK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_sm90<T, kBK><<<dim3(nq, (sq + kBQ - 1) / kBQ, batch), kThreads, kSmemBytes, s>>>(
      qm, km, vm, static_cast<T*>(o), static_cast<float*>(lse), sq, sk, nq, nkv, causal,
      q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int block_k, const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int sq, int sk, int nq, int nkv, int causal,
                        float q_scale, cudaStream_t s) {
  if (block_k == 64)
    return launch<T, 64>(q, k, v, o, lse, batch, sq, sk, nq, nkv, causal, q_scale, s);
  return launch<T, 128>(q, k, v, o, lse, batch, sq, sk, nq, nkv, causal, q_scale, s);
}

}  // namespace

// Dynamic shared memory of the kernel at a key tile of 64 or 128 (-1 for
// another), checked against tune/candidates.py by chip_smoke.py.
extern "C" int flash_fwd_sm90_smem_bytes(int block_k) {
  if (block_k == 64) return KeyTile<64>::kSmemBytes;
  if (block_k == 128) return KeyTile<128>::kSmemBytes;
  return -1;
}

// Plain C entry point, bound with ctypes: the 16-bit forward. Pointers and
// the stream travel as void*; the return value is the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for shapes or types the
// kernel does not take or a tensor map cuTensorMapEncodeTiled refuses. q_scale is
// scale * log2(e), already rounded to the inputs' dtype; block_k is the key
// tile, 64 or 128.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int sq, int sk, int nq, int nkv, int head_dim,
                              int causal, int dtype, float q_scale, int block_k, void* stream) {
  if (batch <= 0 || nkv <= 0 || nq % nkv != 0 || head_dim != kHead || sq <= 0 || sk <= 0 ||
      sq % 64 != 0 || sk % 64 != 0 || (block_k != 64 && block_k != 128)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch_tile<__nv_bfloat16>(block_k, q, k, v, o, lse, batch, sq, sk, nq, nkv, causal,
                                        q_scale, s);
    case kF16:
      return launch_tile<__half>(block_k, q, k, v, o, lse, batch, sq, sk, nq, nkv, causal,
                                 q_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
