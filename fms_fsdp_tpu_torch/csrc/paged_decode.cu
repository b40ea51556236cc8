// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of fms_fsdp_tpu/ops/paged_attention.py:
//   - _paged_decode_kernel (v1, one pool page per grid cell, pools in the
//     compute dtype);
//   - _paged_decode_kernel_v2 (block_kv // page_size pages per cell, int8 or
//     float8_e4m3fn pools dequantised on chip from fp32 row scales).
// One templated kernel covers both contracts: storage bf16 | fp16 | fp32 |
// int8 | e4m3, with optional fp32 row scales. Head dim 128 (every Llama
// variant of the repo); group = Nq / Nkv up to 8.
//
// Contract (paged_attention_reference): q (B, Nq, H); pages (P, ps, Nkv, H);
// page_table (B, maxp) int32; seq_lens (B,) int32. Row b's one query sits at
// position seq_lens[b] and attends to cache positions <= seq_lens[b] through
// its page-table row. Output (B, Nq*H) in q's dtype. A row that attends
// nothing (l == 0) writes zeros, not NaN.
//
// What bounds it: the bytes of K/V it reads. Per (row, kv head) it does
// 4 * group * H flops for each key whose K and V rows are 2 * H storage
// elements, a few flops per byte against the ~295 the H100 needs before
// compute is the limit. What the design does about that:
//   - one block owns one (b, kv_head); it loads its own seq_lens[b] and page
//     table row (the TPU's scalar prefetch has no counterpart here);
//   - the keys 0..seq_lens[b] are walked in tiles of 32; each tile's K and V
//     rows are read from their pool pages once, with 16-byte loads, into
//     shared memory, and serve all group query heads (the GQA reuse the TPU
//     kernel gets from its (group, H) q block);
//   - the next tile's loads are issued into registers before the current
//     tile is computed, so their latency hides behind that work;
//   - pages past seq_lens[b] are neither read nor computed; a tile that runs
//     past seq_lens[b] is masked by key position;
//   - quantized rows are dequantised while they are staged, so K/V cross
//     device memory at one byte per element.
// The fp32 online softmax runs in base 2, with scale * log2(e) folded into q
// and q rounded back to its dtype, as the TPU kernel does; p is rounded to
// the compute dtype before the PV product, and a quantized row is
// dequantised as (q * scale) -> compute dtype before the dot, as there.
//
// Simplicity first: no split-KV across blocks, no cp.async/TMA pipelining,
// no tensor-core MMA. At B=8 and Nkv=8 this launches only 64 blocks on the
// 132 SMs, and the longest row's block walks its whole length alone, so the
// card idles for most of a decode step's attention. Split-KV is the next
// step for speed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHead = 128;       // head dim; one thread per column
constexpr int kThreads = kHead;  // four warps
constexpr int kTileKeys = 32;    // one key per lane in the softmax step
constexpr int kMaxGroup = 8;     // query heads per kv head

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kE4M3 = 4 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// rounding of an fp32 value to the compute dtype, kept in fp32
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// One tile of K/V rows in flight: each thread owns kChunks 16-byte chunks
// of K and of V (a chunk is kVec consecutive elements of one row).
template <typename KT, bool kQuant>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(KT);
  static constexpr int kChunksPerRow = kHead / kVec;
  static constexpr int kChunks = kTileKeys * kChunksPerRow / kThreads;
  uint4 k[kChunks];
  uint4 v[kChunks];
  float ks[kChunks];
  float vs[kChunks];

  // issue the loads of keys t0 .. t0+n_tile-1; rows past n_tile load zeros
  __device__ __forceinline__ void load(const KT* __restrict__ k_pages,
                                       const KT* __restrict__ v_pages,
                                       const float* __restrict__ k_scales,
                                       const float* __restrict__ v_scales,
                                       const int* __restrict__ table_row, int t0,
                                       int n_tile, int page_size, int nkv, int kvh,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int chunk = tid + j * kThreads;
      const int t = chunk / kChunksPerRow;
      const int col = (chunk % kChunksPerRow) * kVec;
      k[j] = make_uint4(0, 0, 0, 0);
      v[j] = make_uint4(0, 0, 0, 0);
      ks[j] = 0.f;
      vs[j] = 0.f;
      if (t < n_tile) {
        const int kpos = t0 + t;
        const int page = table_row[kpos / page_size];
        const int64_t row =
            (static_cast<int64_t>(page) * page_size + kpos % page_size) * nkv + kvh;
        k[j] = *reinterpret_cast<const uint4*>(k_pages + row * kHead + col);
        v[j] = *reinterpret_cast<const uint4*>(v_pages + row * kHead + col);
        if (kQuant) {
          ks[j] = k_scales[row];
          vs[j] = v_scales[row];
        }
      }
    }
  }

  // dequantise / widen into the shared tiles (values of the compute dtype)
  template <typename QT>
  __device__ __forceinline__ void store(float* k_s, float* v_s, int kstride,
                                        int tid) const {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int chunk = tid + j * kThreads;
      const int t = chunk / kChunksPerRow;
      const int col = (chunk % kChunksPerRow) * kVec;
      const KT* kx = reinterpret_cast<const KT*>(&k[j]);
      const KT* vx = reinterpret_cast<const KT*>(&v[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float kf = to_float(kx[e]);
        float vf = to_float(vx[e]);
        if (kQuant) {
          kf = round_to<QT>(kf * ks[j]);
          vf = round_to<QT>(vf * vs[j]);
        }
        k_s[t * kstride + col + e] = kf;
        v_s[t * kHead + col + e] = vf;
      }
    }
  }
};

// QT: q / output / compute dtype; KT: pool storage dtype; kQuant: pools carry
// fp32 row scales (P, ps, Nkv, 1).
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, QT* __restrict__ out, int nkv, int page_size,
    int max_pages, int group, float q_scale) {
  constexpr int kStride = kHead + 1;  // padded: lanes read distinct K rows
  __shared__ float q_s[kMaxGroup * kHead];
  __shared__ float k_s[kTileKeys * kStride];
  __shared__ float v_s[kTileKeys * kHead];
  __shared__ float p_s[kMaxGroup * kTileKeys];
  __shared__ float m_s[kMaxGroup];  // running max, base 2
  __shared__ float l_s[kMaxGroup];  // running denominator
  __shared__ float a_s[kMaxGroup];  // this tile's rescale

  const int G = group;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nq = nkv * G;

  const int pos = seq_lens[b];
  const int capacity = max_pages * page_size;
  const int n_keys = pos < 0 ? 0 : min(pos + 1, capacity);
  const int* table_row = page_table + static_cast<int64_t>(b) * max_pages;

  const int64_t q_off = (static_cast<int64_t>(b) * nq + static_cast<int64_t>(kvh) * G) * kHead;
  for (int i = tid; i < G * kHead; i += kThreads) {
    q_s[i] = round_to<QT>(to_float(q[q_off + i]) * q_scale);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // thread tid owns output column tid of every query head of the group
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  TileRegs<KT, kQuant> regs;
  if (n_keys > 0) {
    regs.load(k_pages, v_pages, k_scales, v_scales, table_row, 0,
              min(kTileKeys, n_keys), page_size, nkv, kvh, tid);
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += kTileKeys) {
    const int n_tile = min(kTileKeys, n_keys - t0);

    // 1. stage this tile, then put the next tile's loads in flight
    regs.template store<QT>(k_s, v_s, kStride, tid);
    __syncthreads();
    const int t1 = t0 + kTileKeys;
    if (t1 < n_keys) {
      regs.load(k_pages, v_pages, k_scales, v_scales, table_row, t1,
                min(kTileKeys, n_keys - t1), page_size, nkv, kvh, tid);
    }

    // 2. scores s[g][t] = q[g] . k[t], already in the base-2 domain
    for (int i = tid; i < G * kTileKeys; i += kThreads) {
      const int g = i / kTileKeys;
      const int t = i - g * kTileKeys;
      const float* qg = q_s + g * kHead;
      const float* kt = k_s + t * kStride;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int c = 0; c < kHead; c += 4) {
        s0 = fmaf(qg[c], kt[c], s0);
        s1 = fmaf(qg[c + 1], kt[c + 1], s1);
        s2 = fmaf(qg[c + 2], kt[c + 2], s2);
        s3 = fmaf(qg[c + 3], kt[c + 3], s3);
      }
      p_s[i] = t < n_tile ? (s0 + s1) + (s2 + s3) : -INFINITY;
    }
    __syncthreads();

    // 3. online softmax: one warp per query head, lane t holds key t
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTileKeys + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: key t0 is always live
      const float p = exp2f(s - m_new);      // masked keys: exp2(-inf) = 0
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * kTileKeys + lane] = round_to<QT>(p);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // first tile: 0
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // 4. acc[g] = acc[g] * alpha[g] + sum_t p[g][t] * v[t][tid]
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) acc[g] *= a_s[g];
    }
    for (int t = 0; t < n_tile; ++t) {
      const float vt = v_s[t * kHead + tid];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) acc[g] = fmaf(p_s[g * kTileKeys + t], vt, acc[g]);
      }
    }
    __syncthreads();
  }

  QT* o = out + q_off;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float l = l_s[g];
      o[g * kHead + tid] = from_float<QT>(l == 0.f ? 0.f : acc[g] / l);
    }
  }
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* page_table,
                   const void* seq_lens, void* out, int batch, int nkv, int page_size,
                   int max_pages, int group, float q_scale, cudaStream_t stream) {
  const dim3 grid(batch, nkv);
  paged_decode_kernel<QT, KT, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<QT*>(out), nkv, page_size,
      max_pages, group, q_scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_pool(int kv_dtype, int q_dtype, const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scales, const void* v_scales,
                          const void* page_table, const void* seq_lens, void* out,
                          int batch, int nkv, int page_size, int max_pages, int group,
                          float q_scale, cudaStream_t stream) {
  const bool quant = k_scales != nullptr;
  if (kv_dtype == kI8 && quant) {
    return launch<QT, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                                    seq_lens, out, batch, nkv, page_size, max_pages,
                                    group, q_scale, stream);
  }
  if (kv_dtype == kE4M3 && quant) {
    return launch<QT, __nv_fp8_e4m3, true>(q, k_pages, v_pages, k_scales, v_scales,
                                           page_table, seq_lens, out, batch, nkv,
                                           page_size, max_pages, group, q_scale, stream);
  }
  if (kv_dtype == q_dtype && !quant) {
    return launch<QT, QT, false>(q, k_pages, v_pages, nullptr, nullptr, page_table, seq_lens,
                                 out, batch, nkv, page_size, max_pages, group, q_scale,
                                 stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers and the stream travel as
// void*; the return value is the cudaError_t of the launch (0 on success).
// q_scale is head_dim ** -0.5 * log2(e), already rounded to q's dtype.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scales, const void* v_scales,
                            const void* page_table, const void* seq_lens, void* out,
                            int batch, int nq, int nkv, int head_dim, int page_size,
                            int max_pages, int q_dtype, int kv_dtype, float q_scale,
                            void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || head_dim != kHead || page_size <= 0 ||
      nq / nkv > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = nq / nkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_pool<float>(kv_dtype, q_dtype, q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, seq_lens, out, batch, nkv, page_size,
                                 max_pages, group, q_scale, s);
      break;
    case kBF16:
      err = dispatch_pool<__nv_bfloat16>(kv_dtype, q_dtype, q, k_pages, v_pages, k_scales,
                                         v_scales, page_table, seq_lens, out, batch, nkv,
                                         page_size, max_pages, group, q_scale, s);
      break;
    case kF16:
      err = dispatch_pool<__half>(kv_dtype, q_dtype, q, k_pages, v_pages, k_scales, v_scales,
                                  page_table, seq_lens, out, batch, nkv, page_size,
                                  max_pages, group, q_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
