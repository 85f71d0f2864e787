// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py : flash_attention_fwd
//           (Pallas body _flash_fwd_kernel).
//
// Computes causal and/or sliding-window attention with GQA: query head h
// reads KV head h / (H / KH). q is (B, S, H, hd), k and v are (B, Sk, KH, hd),
// all read through their strides (the last dim must be contiguous), so the
// caller needs no transpose copies. Softmax is the Pallas kernel's fp32
// online softmax: masked scores are -1e30, the running sum l is clamped to
// 1e-30 at the end, and the output is written in q's dtype.
//
// What bounds it on the card: at the serving shapes (S = 512, hd = 64, bf16)
// the function moves ~33.5 MB and needs ~4.3 GFLOP (causal), so the data
// sheet puts it at the memory bound (~10 us at 3.35 TB/s). Two kernels:
//
//   * bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//     in, fp32 accumulate), tiles fed by ldmatrix from shared memory. Each
//     CTA loads a K/V tile and then computes on it, with no overlap of the
//     two inside the CTA; several CTAs per SM hide part of the latency.
//     wgmma and TMA with a load pipeline are later work.
//   * fp32: scalar fp32 FMAs out of shared memory (bound by shared-memory
//     issue), which keeps full fp32 accuracy (the tests hold fp32 to 2e-5,
//     beyond what bf16 or TF32 tensor-core inputs give).
//
// Common design:
//   * one CTA per (64-row q tile, head, batch);
//   * the k loop visits only tiles that intersect the causal / window mask
//     (the rule of _block_pairs in models/attention.py); the Pallas grid
//     visits every tile;
//   * ragged edges are masked in the kernel: q rows >= S are not stored,
//     keys >= Sk are treated as masked (score -1e30, V row zero);
//   * heavy (late) causal q tiles are launched first to shorten the tail;
//   * head dims 32, 64, 80 (zamba2-2.7b) and 128. At hd 80 the bf16 kernel
//     has 5 16-wide chunks of hd and 10 8-wide output tiles (5 ldmatrix.x4
//     pairs); its shared rows of 88 elements (176 B) keep ldmatrix rows
//     16-byte aligned and conflict-free. The fp32 tiles take ~79 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // q rows per CTA
constexpr int BK = 64;            // keys per tile
constexpr float NEG_INF = -1e30f;

struct Args {
  int S, Sk, H, KH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, window;
};

// first and last k tile that meet the mask of q rows q0 .. min(q0+BQ,S)-1
__device__ __forceinline__ void k_tile_range(const Args& a, int q0, int& lo,
                                             int& hi) {
  const int q_last = min(q0 + BQ, a.S) - 1;
  lo = 0;
  hi = (a.Sk + BK - 1) / BK - 1;
  if (a.causal) hi = min(hi, q_last / BK);
  if (a.window) {
    const int first = q0 - a.window + 1;
    if (first > 0) lo = first / BK;
  }
}

__device__ __forceinline__ bool allowed(const Args& a, int gq, int gk) {
  bool ok = gk < a.Sk;
  if (a.causal) ok = ok && gk <= gq;
  if (a.window) ok = ok && gk > gq - a.window;
  return ok;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs, 256 threads, 4 per q row
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int COLS_PER_T = BK / 4;
constexpr int PS_STRIDE = BK + 4;  // conflict-free rows of the P tile

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) + size_t(BK) * HD +
          size_t(BQ) * PS_STRIDE);
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);          // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);          // [BK][HD]
  float* Ps = Vs + BK * HD;                // [BQ][PS_STRIDE]

  const int tid = threadIdx.x;
  const int r = tid >> 2;                  // q row in the tile
  const int c4 = tid & 3;                  // column phase in the row group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int gq = q0 + r;

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + kh * a.k_sh;
  const float* vb = v + b * a.v_sb + kh * a.v_sh;

  for (int i = tid; i < BQ * HD; i += F32_THREADS) {
    const int rr = i / HD, d = i % HD;
    const int g = q0 + rr;
    Qs[rr * (HD + 1) + d] = g < a.S ? qb[g * a.q_ss + d] : 0.f;
  }
  int j_lo, j_hi;
  k_tile_range(a, q0, j_lo, j_hi);

  float m = NEG_INF, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                       // previous tile fully consumed
    for (int i = tid; i < BK * HD; i += F32_THREADS) {
      const int rr = i / HD, d = i % HD;
      const int g = k0 + rr;
      const bool in = g < a.Sk;
      Ks[rr * (HD + 1) + d] = in ? kb[g * a.k_ss + d] : 0.f;
      Vs[rr * HD + d] = in ? vb[g * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[COLS_PER_T];
#pragma unroll
    for (int i = 0; i < COLS_PER_T; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[r * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < COLS_PER_T; ++i)
        s[i] = fmaf(qv, Ks[(c4 + 4 * i) * (HD + 1) + d], s[i]);
    }

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < COLS_PER_T; ++i) {
      s[i] = allowed(a, gq, k0 + c4 + 4 * i) ? s[i] * a.scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < COLS_PER_T; ++i) {
      const float p = expf(s[i] - m_new);
      sum += p;
      Ps[r * PS_STRIDE + c4 + 4 * i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();                          // the row's P is written

#pragma unroll
    for (int j = 0; j < HD / 4; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PS_STRIDE + c];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j)
        acc[j] = fmaf(p, Vs[c * HD + c4 + 4 * j], acc[j]);
    }
  }

  if (gq < a.S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* ob = o + b * a.o_sb + gq * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) ob[c4 + 4 * j] = acc[j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, 4 warps, 16 q rows a warp
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, the fp32 accumulator of a 16x8 tile holds (row g, cols 2t,
// 2t+1) in c0, c1 and (row g+8, same cols) in c2, c3. Two neighbouring
// accumulator tiles (16 keys) packed to bf16 are exactly the A fragment of
// the next product (P @ V), so P never leaves registers.

constexpr int MMA_THREADS = 128;                 // 4 warps x 16 q rows

template <int HD>
__host__ __device__ constexpr int mma_stride() { return HD + 8; }  // 16 B pad

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(BQ + 2 * BK) * mma_stride<HD>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a (rows, HD) bf16 matrix with row stride
// ``ss`` into shared memory; rows >= n_rows are zero. 16-byte copies: the
// wrapper guarantees 16-byte aligned rows.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0,
                                          int n_rows) {
  constexpr int CHUNKS = HD / 8;           // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int g = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g < n_rows)
      val = *reinterpret_cast<const uint4*>(src + g * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * mma_stride<HD>() + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Args a) {
  constexpr int LD = mma_stride<HD>();
  constexpr int KC = HD / 16;              // 16-wide chunks of hd
  constexpr int NT = BK / 8;               // 8-key score tiles a k tile
  constexpr int DT = HD / 8;               // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int row_a = q0 + warp * 16 + g;   // this thread's two q rows
  const int row_b = row_a + 8;

  load_tile<HD>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
  __syncthreads();

  // the warp's 16 q rows as A fragments, one per 16-wide chunk of hd
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* p =
        Qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3], smem_u32(p));
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int j_lo, j_hi;
  k_tile_range(a, q0, j_lo, j_hi);
  const __nv_bfloat16* kb = k + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vb = v + b * a.v_sb + kh * a.v_sh;
  // ldmatrix row/column picked by this lane within an x4 load
  const int mi = lane >> 3, mr = lane & 7;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                       // previous tile fully consumed
    load_tile<HD>(Ks, kb, a.k_ss, k0, a.Sk);
    load_tile<HD>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        const __nv_bfloat16* p =
            Ks + (np * 16 + (mi >> 1) * 8 + mr) * LD + kc * 16 + (mi & 1) * 8;
        ldmatrix_x4(b0, b1, b2, b3, smem_u32(p));
        mma_bf16(s[2 * np], qf[kc], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kc], b2, b3);
      }
    }

    // mask, scale and online softmax over the two rows this thread holds
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + n * 8 + 2 * t + (e & 1);
        const int gq = e < 2 ? row_a : row_b;
        s[n][e] = allowed(a, gq, gk) ? s[n][e] * a.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += P V, 16 keys at a time; P is packed to bf16 in registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        const __nv_bfloat16* p =
            Vs + (kc * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(p));
        mma_bf16(acc[2 * dp], pa, b0, b1);
        mma_bf16(acc[2 * dp + 1], pa, b2, b3);
      }
    }
  }

  const float inv_a = 1.f / fmaxf(l[0], 1e-30f);
  const float inv_b = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = o + b * a.o_sb + h * a.o_sh + 2 * t;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (row_a < a.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * a.o_ss + i * 8) =
          __floats2bfloat162_rn(acc[i][0] * inv_a, acc[i][1] * inv_a);
    if (row_b < a.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * a.o_ss + i * 8) =
          __floats2bfloat162_rn(acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* o, int B, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return int(cudaGetLastError());
}

Args make_args(int S, int Sk, int H, int KH, long long q_sb, long long q_ss,
               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh, long long o_sb,
               long long o_ss, long long o_sh, float scale, int causal,
               int window) {
  Args a;
  a.S = S; a.Sk = Sk; a.H = H; a.KH = KH;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale; a.causal = causal; a.window = window;
  return a;
}

bool bad_shape(int B, int S, int Sk, int H, int KH) {
  return B <= 0 || S <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0;
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int KH, int hd,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh,
                   float scale, int causal, int window, void* stream) {
  if (bad_shape(B, S, Sk, H, KH)) return int(cudaErrorInvalidValue);
  // 16-byte row loads: pointers and row strides must keep 16-byte alignment
  const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh};
  for (long long st : strides)
    if (st % 8) return int(cudaErrorMisalignedAddress);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 ||
      (o_ss % 2) || (o_sb % 2) || (o_sh % 2) ||
      reinterpret_cast<uintptr_t>(o) % 4)
    return int(cudaErrorMisalignedAddress);
  const Args a = make_args(S, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                           window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<decltype(&flash_fwd_bf16_kernel<32>), __nv_bfloat16>(
          flash_fwd_bf16_kernel<32>, MMA_THREADS, bf16_smem_bytes<32>(), q, k,
          v, o, B, a, st);
    case 64:
      return launch<decltype(&flash_fwd_bf16_kernel<64>), __nv_bfloat16>(
          flash_fwd_bf16_kernel<64>, MMA_THREADS, bf16_smem_bytes<64>(), q, k,
          v, o, B, a, st);
    case 80:
      return launch<decltype(&flash_fwd_bf16_kernel<80>), __nv_bfloat16>(
          flash_fwd_bf16_kernel<80>, MMA_THREADS, bf16_smem_bytes<80>(), q, k,
          v, o, B, a, st);
    case 128:
      return launch<decltype(&flash_fwd_bf16_kernel<128>), __nv_bfloat16>(
          flash_fwd_bf16_kernel<128>, MMA_THREADS, bf16_smem_bytes<128>(), q,
          k, v, o, B, a, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int Sk, int H, int KH, int hd, long long q_sb,
                  long long q_ss, long long q_sh, long long k_sb,
                  long long k_ss, long long k_sh, long long v_sb,
                  long long v_ss, long long v_sh, long long o_sb,
                  long long o_ss, long long o_sh, float scale, int causal,
                  int window, void* stream) {
  if (bad_shape(B, S, Sk, H, KH)) return int(cudaErrorInvalidValue);
  const Args a = make_args(S, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                           window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<decltype(&flash_fwd_f32_kernel<32>), float>(
          flash_fwd_f32_kernel<32>, F32_THREADS, f32_smem_bytes<32>(), q, k,
          v, o, B, a, st);
    case 64:
      return launch<decltype(&flash_fwd_f32_kernel<64>), float>(
          flash_fwd_f32_kernel<64>, F32_THREADS, f32_smem_bytes<64>(), q, k,
          v, o, B, a, st);
    case 80:
      return launch<decltype(&flash_fwd_f32_kernel<80>), float>(
          flash_fwd_f32_kernel<80>, F32_THREADS, f32_smem_bytes<80>(), q, k,
          v, o, B, a, st);
    case 128:
      return launch<decltype(&flash_fwd_f32_kernel<128>), float>(
          flash_fwd_f32_kernel<128>, F32_THREADS, f32_smem_bytes<128>(), q, k,
          v, o, B, a, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
