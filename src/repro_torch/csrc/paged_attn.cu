// Paged-KV decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/paged_attn/kernel.py : paged_attention
//           (Pallas body _paged_kernel, scalar-prefetch grid).
//
// One query token per sequence attends over a KV cache kept in a page
// pool: k_pages / v_pages are (n_pages, page_sz, KH, hd), read through
// their strides (last dim contiguous), so a dense (B, Smax, KH, hd) cache
// viewed as (B * Smax / page_sz, page_sz, KH, hd) is used in place, with
// no transpose into the Pallas layout. Row b of page_table (B, nblk) int32
// lists the pages of sequence b in logical order; positions >= lengths[b]
// are masked to -1e30, so a zero-length row gives the mean of V over the
// table's slots, as the Pallas kernel does. Softmax is fp32 online softmax
// across pages; the output is written in q's dtype.
//
// What bounds it on the card: bytes. A decode step reads every cached K/V
// byte of the sequence once and does 4 FLOPs per byte-pair, far below the
// card's ~295 FLOP/byte balance point; at B=4, 32 KV heads, hd 64 and 543
// cached tokens a layer reads ~17.8 MB (~5.3 us at 3.35 TB/s). This first
// version walks the pages one after another inside each CTA, with three
// block barriers a page, so it is bound by latency rather than bandwidth;
// splitting the pages across warps (with a fixed merge order) is later work.
//
// Design:
//   * one CTA per (kv head, sequence) handles the G = H / KH query rows that
//     share the KV head (GQA); 128 threads;
//   * the CTA reads page_table and lengths from global memory itself: CUDA
//     has no scalar prefetch;
//   * per page: each warp takes tokens t = warp, warp + 4, ...; its lanes
//     split hd and reduce the dot product with a fixed butterfly; one warp
//     per query row then takes the page's max and sum with the same
//     butterfly; each thread updates its (row, d) accumulators with a
//     sequential loop over the page's tokens;
//   * the reduction order depends only on the logical position (page j of
//     the table, token t in the page), never on the physical page index,
//     and no atomics are used: the same pages under a permuted table give
//     bit-identical output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ACC = 8;                 // (G * hd) <= THREADS * MAX_ACC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ table,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  int H, int KH, int hd, int page_sz, int nblk,
                  long long q_sb, long long q_sh, long long k_sp,
                  long long k_st, long long k_sh, long long v_sp,
                  long long v_st, long long v_sh, long long t_sb,
                  long long o_sb, long long o_sh, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  float* qs = smem;                        // [G][hd]
  float* sc = qs + G * hd;                 // [G][page_sz] scores, then p
  float* m_s = sc + G * page_sz;           // [G]
  float* l_s = m_s + G;                    // [G]
  float* c_s = l_s + G;                    // [G] correction of this page

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const int* trow = table + b * t_sb;

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f(q[b * q_sb + (kh * G + g) * q_sh + d]);
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const long long page = trow[j];
    const T* kbase = kp + page * k_sp + kh * k_sh;
    const T* vbase = vp + page * v_sp + kh * v_sh;
    const int pos0 = j * page_sz;

    // scores of this page: warp-strided tokens, lanes split hd
    for (int t = warp; t < page_sz; t += WARPS) {
      const T* krow = kbase + t * k_st;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32)
          part = fmaf(qs[g * hd + d], to_f(krow[d]), part);
        part = warp_sum(part);
        if (lane == 0)
          sc[g * page_sz + t] = (pos0 + t < len) ? part * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per query row
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < page_sz; t += 32)
        mx = fmaxf(mx, sc[g * page_sz + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page_sz; t += 32) {
        const float p = expf(sc[g * page_sz + t] - m_new);
        sc[g * page_sz + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d], t in page order
#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < G * hd) {
        const int g = e / hd, d = e % hd;
        const float* p = sc + g * page_sz;
        float a = acc[i] * c_s[g];
#pragma unroll 8                           // loads in flight; same FMA order
        for (int t = 0; t < page_sz; ++t)
          a = fmaf(p[t], to_f(vbase[t * v_st + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();                       // sc is rewritten by the next page
  }

#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < G * hd) {
      const int g = e / hd, d = e % hd;
      out[b * o_sb + (kh * G + g) * o_sh + d] =
          from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* out, int B, int H, int KH, int hd,
           int page_sz, int nblk, long long q_sb, long long q_sh,
           long long k_sp, long long k_st, long long k_sh, long long v_sp,
           long long v_st, long long v_sh, long long t_sb, long long o_sb,
           long long o_sh, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || hd <= 0 || page_sz <= 0 ||
      nblk <= 0 || (H / KH) * hd > THREADS * MAX_ACC)
    return int(cudaErrorInvalidValue);
  const int G = H / KH;
  const size_t smem = sizeof(float) * (size_t(G) * hd + size_t(G) * page_sz +
                                       3 * size_t(G));
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(KH, B);
  paged_attn_kernel<T><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(out), H, KH,
      hd, page_sz, nblk, q_sb, q_sh, k_sp, k_st, k_sh, v_sp, v_st, v_sh, t_sb,
      o_sb, o_sh, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define PAGED_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* kp, const void* vp, const void* table, \
           const void* lengths, void* out, int B, int H, int KH, int hd,     \
           int page_sz, int nblk, long long q_sb, long long q_sh,            \
           long long k_sp, long long k_st, long long k_sh, long long v_sp,   \
           long long v_st, long long v_sh, long long t_sb, long long o_sb,   \
           long long o_sh, float scale, void* stream) {                      \
    return launch<T>(q, kp, vp, static_cast<const int*>(table),              \
                     static_cast<const int*>(lengths), out, B, H, KH, hd,    \
                     page_sz, nblk, q_sb, q_sh, k_sp, k_st, k_sh, v_sp,      \
                     v_st, v_sh, t_sb, o_sb, o_sh, scale, stream);           \
  }

PAGED_ENTRY(paged_attn_bf16, __nv_bfloat16)
PAGED_ENTRY(paged_attn_f32, float)

#undef PAGED_ENTRY

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
