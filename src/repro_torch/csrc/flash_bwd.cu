// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/models/attention.py:211-286, the jnp block-recompute
//           backward of the flash custom VJP (the JAX package has no Pallas
//           backward kernel; its forward is the Pallas kernel that
//           csrc/flash_fwd.cu replaces).
//
// Computes the gradient of causal and/or sliding-window attention with GQA
// from (q, k, v, o, lse, do): q, o, do are (B, S, H, hd), k and v
// (B, Sk, KH, hd), all read through their strides (the last dim must be
// contiguous); lse is the forward's (B, H, S) fp32 log-sum-exp of the scaled
// scores. With D = rowsum(do * o), for every (q row, key) the mask allows:
//   p = exp(scale q.k - lse),  dv += p do,  dp = do.v,
//   ds = p (dp - D) scale,     dq += ds k,  dk += ds q,
// all in fp32 from inputs of either dtype; dq/dk/dv are written contiguous
// in the inputs' dtype, dk/dv summed over the G query heads of a KV head.
//
// What bounds it on the card: at the training shape (B 2, S 4096, 32 heads
// of 64, causal, bf16) the function moves ~268 MB (q/k/v/o/do read once,
// dq/dk/dv written once) and needs five causal products, ~344 GFLOP: the
// data sheet puts it at the bf16 tensor-core bound (~0.35 ms at 989
// TFLOP/s; 0.08 ms for the bytes). Two sets of kernels, one split:
//   * bf16 (training): the products on the tensor cores, mma.sync
//     m16n8k16 with fp32 sums, from bf16 tiles in shared memory read with
//     ldmatrix; P^T, dS^T and dS are rounded to bf16 as the A operands of
//     the second products and never leave registers (the forward rounds P
//     the same way). Simple rather than fast: no pipelining of the tile
//     loads, 4 warps a CTA; PERF.md has its time beside the bound;
//   * fp32: scalar fp32 FMAs out of shared memory (bound by shared-memory
//     issue), which keeps full fp32 accuracy.
//
// Design (the common FlashAttention-2 split, deterministic: no atomics,
// every sum in a fixed order, so two calls give the same bits):
//   * flash_bwd_dot_kernel: D = rowsum(do * o), one warp a (b, s, h) row;
//   * flash_bwd_dkdv_kernel: one CTA per (k tile of 64 keys, KV head, b)
//     keeps its K and V tiles in shared memory and dK/dV in registers,
//     and loops over the G query heads of its KV head and, for each, over
//     the 64-row q tiles that meet the causal / window mask of its keys:
//     it recomputes S and dP for the (q tile x k tile), forms P and dS in
//     shared memory, and accumulates dV += P^T dO and dK += dS^T Q;
//   * flash_bwd_dq_kernel: one CTA per (q tile, q head, b) keeps Q, dO,
//     lse and D of its rows and dQ in registers, and loops over the k tiles
//     that meet its mask (the rule of the forward), recomputing S, dP and
//     dS and accumulating dQ += dS K.
// S and dP are computed twice (once per kernel): 7 products instead of 5,
// the price of no atomics. Tiles that the mask discards entirely are never
// visited; rows >= S and keys >= Sk are masked (p = 0) and not stored.
// Heavy tiles launch first (early k tiles; late q tiles). In the fp32
// kernels a thread of the 256 owns a 4 x 4 block of each 64 x 64 score
// tile (rows ty + 16 i, keys tx + 16 j) and 4 x hd/16 of each output tile;
// tiles are fp32 in shared memory with odd row strides (hd + 1), so no
// warp's loads conflict. In the bf16 kernels each of 4 warps owns 16 rows
// (keys for dK/dV, q rows for dQ) of the CTA's 64 and every 64-wide tile
// it meets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;            // q rows a tile
constexpr int BK = 64;            // keys a tile
constexpr int THREADS = 256;
constexpr int PS = BK + 16;       // row stride of the P / dS tiles

struct Args {
  int B, S, Sk, H, KH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool allowed(const Args& a, int gq, int gk) {
  bool ok = gq < a.S && gk < a.Sk;
  if (a.causal) ok = ok && gk <= gq;
  if (a.window) ok = ok && gk > gq - a.window;
  return ok;
}

template <int HD>
__host__ __device__ constexpr size_t tile_floats() {
  return size_t(BQ) * (HD + 1);   // a q or k tile of hd columns
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {     // K, V, Q, dO, P, dS, lse, D
  return sizeof(float) * (4 * tile_floats<HD>() + 2 * size_t(BQ) * PS +
                          2 * BQ);
}

template <int HD>
constexpr size_t dq_smem_bytes() {       // Q, dO, K, V, dS, lse, D
  return sizeof(float) * (4 * tile_floats<HD>() + size_t(BQ) * PS + 2 * BQ);
}

// 64 rows of hd columns from row r0 of a (rows, hd) view with row stride
// ss into shared memory (row stride hd + 1); rows >= limit are zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long ss, int r0, int limit) {
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int g = r0 + r;
    dst[r * (HD + 1) + d] = g < limit ? base[g * ss + d] : 0.f;
  }
}

// lse and D of 64 rows from r0 (rows >= S: 0, masked anyway)
__device__ __forceinline__ void load_rows(float* lse_s, float* D_s,
                                          const float* lb, const float* Db,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int g = r0 + i;
    lse_s[i] = g < S ? lb[g] : 0.f;
    D_s[i] = g < S ? Db[g] : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for this thread's 4 x 4 block (q rows
// ty + 16 i, keys tx + 16 j) of the 64 x 64 tile
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
      dov[i] = dOs[(ty + 16 * i) * (HD + 1) + d];
      kv[i] = Ks[(tx + 16 * i) * (HD + 1) + d];
      vv[i] = Vs[(tx + 16 * i) * (HD + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
}

// p and ds of this thread's block into shared memory (P only if Ps)
__device__ __forceinline__ void softmax_grad(const Args& a, int q0, int k0,
                                             int ty, int tx,
                                             const float (&s)[4][4],
                                             const float (&dp)[4][4],
                                             const float* lse_s,
                                             const float* D_s, float* Ps,
                                             float* dSs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse_r = lse_s[r], D_r = D_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          allowed(a, q0 + r, k0 + c) ? expf(s[i][j] * a.scale - lse_r) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - D_r) * a.scale;
    }
  }
}

// D = rowsum(do * o): one warp a (b, s, h) row, written (B, H, S)
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ D, Args a, int hd) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.S * a.H) return;
  const int h = int(row % a.H);
  const int s = int((row / a.H) % a.S);
  const int b = int(row / ((long long)a.H * a.S));
  const T* ob = o + b * a.o_sb + s * a.o_ss + h * a.o_sh;
  const T* db = dout + b * a.do_sb + s * a.do_ss + h * a.do_sh;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f(ob[d]), to_f(db[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[((long long)b * a.H + h) * a.S + s] = acc;
}

// one CTA per (k tile, KV head, b): dK and dV of its 64 keys
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, Args a) {
  constexpr int NJ = HD / 16;              // output columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + tile_floats<HD>();
  float* Qs = Vs + tile_floats<HD>();
  float* dOs = Qs + tile_floats<HD>();
  float* Ps = dOs + tile_floats<HD>();
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* D_s = lse_s + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;          // early keys (most work) first
  const int G = a.H / a.KH;
  load_tile<HD>(Ks, k + b * a.k_sb + kh * a.k_sh, a.k_ss, k0, a.Sk);
  load_tile<HD>(Vs, v + b * a.v_sb + kh * a.v_sh, a.v_ss, k0, a.Sk);

  // the q tiles whose rows may see one of keys k0 .. k_last
  const int k_last = min(k0 + BK, a.Sk) - 1;
  const int it_lo = a.causal ? k0 / BQ : 0;
  int it_hi = (a.S + BQ - 1) / BQ - 1;
  if (a.window) it_hi = min(it_hi, (k_last + a.window - 1) / BQ);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + b * a.q_sb + h * a.q_sh;
    const float* dob = dout + b * a.do_sb + h * a.do_sh;
    const float* lb = lse + ((long long)b * a.H + h) * a.S;
    const float* Db = D + ((long long)b * a.H + h) * a.S;
    for (int it = it_lo; it <= it_hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();                     // the previous tile is consumed
      load_tile<HD>(Qs, qb, a.q_ss, q0, a.S);
      load_tile<HD>(dOs, dob, a.do_ss, q0, a.S);
      load_rows(lse_s, D_s, lb, Db, q0, a.S);
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      softmax_grad(a, q0, k0, ty, tx, s, dp, lse_s, D_s, Ps, dSs);
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * PS + ty + 16 * i];
          dsv[i] = dSs[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = dOs[r * (HD + 1) + tx + 16 * j];
          const float qv = Qs[r * (HD + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
    if (gk >= a.Sk) continue;
    const long long row = ((long long)b * a.Sk + gk) * a.KH + kh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[row * HD + tx + 16 * j] = dk_acc[i][j];
      dv[row * HD + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// one CTA per (q tile, q head, b): dQ of its 64 rows
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq,
                    Args a) {
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + tile_floats<HD>();
  float* Ks = dOs + tile_floats<HD>();
  float* Vs = Ks + tile_floats<HD>();
  float* dSs = Vs + tile_floats<HD>();
  float* lse_s = dSs + BQ * PS;
  float* D_s = lse_s + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // late rows first
  const float* kb = k + b * a.k_sb + kh * a.k_sh;
  const float* vb = v + b * a.v_sb + kh * a.v_sh;
  load_tile<HD>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
  load_tile<HD>(dOs, dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, a.S);
  load_rows(lse_s, D_s, lse + ((long long)b * a.H + h) * a.S,
            D + ((long long)b * a.H + h) * a.S, q0, a.S);

  // the k tiles that meet the mask of rows q0 .. min(q0 + 64, S) - 1
  const int q_last = min(q0 + BQ, a.S) - 1;
  int j_lo = 0, j_hi = (a.Sk + BK - 1) / BK - 1;
  if (a.causal) j_hi = min(j_hi, q_last / BK);
  if (a.window && q0 - a.window + 1 > 0) j_lo = (q0 - a.window + 1) / BK;

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile<HD>(Ks, kb, a.k_ss, k0, a.Sk);
    load_tile<HD>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    softmax_grad(a, q0, k0, ty, tx, s, dp, lse_s, D_s, nullptr, dSs);
    __syncthreads();

    // dQ += dS K: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[c * (HD + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dq_acc[i][j] = fmaf(dsv[i], kv, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= a.S) continue;
    const long long row = ((long long)b * a.S + gq) * a.H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[row * HD + tx + 16 * j] = dq_acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: the same split on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma .m16n8k16, bf16 inputs, fp32 sums): with
// g = lane / 4 and t = lane % 4, an accumulator holds (row g, cols 2t,
// 2t + 1) and (row g + 8, the same cols) of its 16 x 8 tile. Two
// neighbouring 8-column tiles of an accumulator, packed to bf16, are
// exactly the A fragment of a product over those 16 columns, so P^T, dS^T
// and dS never leave registers. Tiles are bf16 in shared memory with rows
// of hd + 8 elements (16-byte aligned, no ldmatrix bank conflicts).

constexpr int M_ROWS = 64;        // keys (dK/dV) or q rows (dQ) a CTA
constexpr int M_THREADS = 128;    // 4 warps of 16 rows each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of columns 16 kk .. 16 kk + 15 of an accumulator row block
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// lane's address for an A fragment (rows r0 .. r0 + 15, cols c0 .. c0 + 15)
// of a row-major tile, or for two B fragments (n tiles n0, n0 + 8; k cols
// c0 .. c0 + 15) of a tile stored n-major (B = the tile's transpose)
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* a_addr(
    const __nv_bfloat16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_addr(
    const __nv_bfloat16* tile, int n0, int c0, int lane) {
  const int mi = lane >> 3;
  return tile + (n0 + (mi >> 1) * 8 + (lane & 7)) * LD + c0 + (mi & 1) * 8;
}
// two B fragments (n tiles n0, n0 + 8; k rows k0 .. k0 + 15) of a tile
// stored k-major, read with ldmatrix.trans
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* bt_addr(
    const __nv_bfloat16* tile, int k0, int n0, int lane) {
  const int mi = lane >> 3;
  return tile + (k0 + (mi & 1) * 8 + (lane & 7)) * LD + n0 + (mi >> 1) * 8;
}

// 64 rows of HD bf16 from row r0 of a (rows, HD) view with row stride ss
// into shared memory (row stride HD + 8), 16 bytes a load; rows >= limit
// are zeros
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* base,
                                               long long ss, int r0,
                                               int limit) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < M_ROWS * CH; i += M_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int g = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g < limit) val = *reinterpret_cast<const uint4*>(base + g * ss + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

__device__ __forceinline__ void load_rows_m(float* lse_s, float* D_s,
                                            const float* lb, const float* Db,
                                            int r0, int S) {
  for (int i = threadIdx.x; i < M_ROWS; i += M_THREADS) {
    const int g = r0 + i;
    lse_s[i] = g < S ? lb[g] : 0.f;
    D_s[i] = g < S ? Db[g] : 0.f;
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {      // four bf16 tiles, lse, D
  return 4 * size_t(M_ROWS) * (HD + 8) * 2 + 2 * M_ROWS * sizeof(float);
}

// one CTA per (k tile of 64 keys, KV head, b); warp w owns keys 16 w ..
// 16 w + 15 of the tile and works in the transposed orientation:
// S^T = K Q^T and dP^T = V dO^T (16 keys x 64 q rows), then
// dV += P^T dO and dK += dS^T Q
template <int HD>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Args a) {
  constexpr int LD = HD + 8, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + M_ROWS * LD;
  __nv_bfloat16* Qs = Vs + M_ROWS * LD;
  __nv_bfloat16* dOs = Qs + M_ROWS * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + M_ROWS * LD);
  float* D_s = lse_s + M_ROWS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * M_ROWS;      // early keys (most work) first
  const int kw = warp * 16;                // this warp's keys in the tile
  const int G = a.H / a.KH;
  load_tile_bf16<HD>(Ks, k + b * a.k_sb + kh * a.k_sh, a.k_ss, k0, a.Sk);
  load_tile_bf16<HD>(Vs, v + b * a.v_sb + kh * a.v_sh, a.v_ss, k0, a.Sk);

  const int k_last = min(k0 + M_ROWS, a.Sk) - 1;
  const int it_lo = a.causal ? k0 / M_ROWS : 0;
  int it_hi = (a.S + M_ROWS - 1) / M_ROWS - 1;
  if (a.window) it_hi = min(it_hi, (k_last + a.window - 1) / M_ROWS);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    const __nv_bfloat16* qb = q + b * a.q_sb + h * a.q_sh;
    const __nv_bfloat16* dob = dout + b * a.do_sb + h * a.do_sh;
    const float* lb = lse + ((long long)b * a.H + h) * a.S;
    const float* Db = D + ((long long)b * a.H + h) * a.S;
    for (int it = it_lo; it <= it_hi; ++it) {
      const int q0 = it * M_ROWS;
      __syncthreads();                     // the previous tile is consumed
      load_tile_bf16<HD>(Qs, qb, a.q_ss, q0, a.S);
      load_tile_bf16<HD>(dOs, dob, a.do_ss, q0, a.S);
      load_rows_m(lse_s, D_s, lb, Db, q0, a.S);
      __syncthreads();

      float st[8][4], dpt[8][4];           // 16 keys x 64 q rows
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_addr<LD>(Ks, kw, 16 * kk, lane));
        ldsm_x4(va, a_addr<LD>(Vs, kw, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, b_addr<LD>(Qs, 16 * np, 16 * kk, lane));
          ldsm_x4(of, b_addr<LD>(dOs, 16 * np, 16 * kk, lane));
          mma16816(st[2 * np], ka, qf[0], qf[1]);
          mma16816(st[2 * np + 1], ka, qf[2], qf[3]);
          mma16816(dpt[2 * np], va, of[0], of[1]);
          mma16816(dpt[2 * np + 1], va, of[2], of[3]);
        }
      }

      // P^T and dS^T in place (masked entries 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int key = k0 + kw + g + (e >> 1) * 8;
          const float p = allowed(a, q0 + qi, key)
                              ? expf(st[j][e] * a.scale - lse_s[qi])
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - D_s[qi]) * a.scale;
        }

      // dV += P^T dO, dK += dS^T Q over the 64 q rows, 16 at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st, kk);
        acc_to_a(sa, dpt, kk);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t of[4], qf[4];
          ldsm_x4_trans(of, bt_addr<LD>(dOs, 16 * kk, 16 * np, lane));
          ldsm_x4_trans(qf, bt_addr<LD>(Qs, 16 * kk, 16 * np, lane));
          mma16816(dv_acc[2 * np], pa, of[0], of[1]);
          mma16816(dv_acc[2 * np + 1], pa, of[2], of[3]);
          mma16816(dk_acc[2 * np], sa, qf[0], qf[1]);
          mma16816(dk_acc[2 * np + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gk = k0 + kw + g + 8 * half;
    if (gk >= a.Sk) continue;
    const long long row = ((long long)b * a.Sk + gk) * a.KH + kh;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + row * HD + d) =
          __floats2bfloat162_rn(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row * HD + d) =
          __floats2bfloat162_rn(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  }
}

// one CTA per (q tile of 64 rows, q head, b); warp w owns q rows 16 w ..
// 16 w + 15, keeps their Q and dO as A fragments, and loops over the k
// tiles: S = Q K^T, dP = dO V^T (16 rows x 64 keys), dQ += dS K
template <int HD>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D,
                        __nv_bfloat16* __restrict__ dq, Args a) {
  constexpr int LD = HD + 8, NT = HD / 8, KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + M_ROWS * LD;
  __nv_bfloat16* Ks = dOs + M_ROWS * LD;
  __nv_bfloat16* Vs = Ks + M_ROWS * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + M_ROWS * LD);
  float* D_s = lse_s + M_ROWS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * M_ROWS;   // late rows first
  const int qw = warp * 16;
  const __nv_bfloat16* kb = k + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vb = v + b * a.v_sb + kh * a.v_sh;
  load_tile_bf16<HD>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
  load_tile_bf16<HD>(dOs, dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0,
                     a.S);
  load_rows_m(lse_s, D_s, lse + ((long long)b * a.H + h) * a.S,
              D + ((long long)b * a.H + h) * a.S, q0, a.S);
  __syncthreads();
  uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(qa[kk], a_addr<LD>(Qs, qw, 16 * kk, lane));
    ldsm_x4(oa[kk], a_addr<LD>(dOs, qw, 16 * kk, lane));
  }
  const float lse_r[2] = {lse_s[qw + g], lse_s[qw + g + 8]};
  const float D_r[2] = {D_s[qw + g], D_s[qw + g + 8]};

  const int q_last = min(q0 + M_ROWS, a.S) - 1;
  int j_lo = 0, j_hi = (a.Sk + M_ROWS - 1) / M_ROWS - 1;
  if (a.causal) j_hi = min(j_hi, q_last / M_ROWS);
  if (a.window && q0 - a.window + 1 > 0)
    j_lo = (q0 - a.window + 1) / M_ROWS;

  float dq_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * M_ROWS;
    __syncthreads();                       // the previous tile is consumed
    load_tile_bf16<HD>(Ks, kb, a.k_ss, k0, a.Sk);
    load_tile_bf16<HD>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();

    float s[8][4], dp[8][4];               // 16 q rows x 64 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_addr<LD>(Ks, 16 * np, 16 * kk, lane));
        ldsm_x4(vf, b_addr<LD>(Vs, 16 * np, 16 * kk, lane));
        mma16816(s[2 * np], qa[kk], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa[kk], kf[2], kf[3]);
        mma16816(dp[2 * np], oa[kk], vf[0], vf[1]);
        mma16816(dp[2 * np + 1], oa[kk], vf[2], vf[3]);
      }

    // dS in place of S (masked entries 0)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int gq = q0 + qw + g + (e >> 1) * 8;
        const float p = allowed(a, gq, key)
                            ? expf(s[j][e] * a.scale - lse_r[e >> 1])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - D_r[e >> 1]) * a.scale;
      }

    // dQ += dS K over the 64 keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s, kk);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, bt_addr<LD>(Ks, 16 * kk, 16 * np, lane));
        mma16816(dq_acc[2 * np], sa, kf[0], kf[1]);
        mma16816(dq_acc[2 * np + 1], sa, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gq = q0 + qw + g + 8 * half;
    if (gq >= a.S) continue;
    const long long row = ((long long)b * a.S + gq) * a.H + h;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + row * HD + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dq_acc[j][2 * half],
                                dq_acc[j][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// launch: D, then dK/dV, then dQ, in order on one stream
// ---------------------------------------------------------------------------

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* D, void* dq, void* dk,
           void* dv, const Args& a, cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* D_ = static_cast<float*>(D);

  constexpr int ROWS_PER_CTA = 8;          // warps of the D pre-pass
  const long long rows = (long long)a.B * a.S * a.H;
  flash_bwd_dot_kernel<T><<<unsigned((rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA),
                            32 * ROWS_PER_CTA, 0, st>>>(
      static_cast<const T*>(o), do_, D_, a, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = mma_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    flash_bwd_dkdv_mma_kernel<HD>
        <<<dim3((a.Sk + M_ROWS - 1) / M_ROWS, a.KH, a.B), M_THREADS, smem,
           st>>>(q_, k_, v_, do_, lse_, D_, static_cast<T*>(dk),
                 static_cast<T*>(dv), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    flash_bwd_dq_mma_kernel<HD>
        <<<dim3((a.S + M_ROWS - 1) / M_ROWS, a.H, a.B), M_THREADS, smem,
           st>>>(q_, k_, v_, do_, lse_, D_, static_cast<T*>(dq), a);
  } else {
    const size_t smem_kv = dkdv_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_kv));
    if (err != cudaSuccess) return int(err);
    flash_bwd_dkdv_kernel<HD>
        <<<dim3((a.Sk + BK - 1) / BK, a.KH, a.B), THREADS, smem_kv, st>>>(
            q_, k_, v_, do_, lse_, D_, static_cast<T*>(dk),
            static_cast<T*>(dv), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);

    const size_t smem_q = dq_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_q));
    if (err != cudaSuccess) return int(err);
    flash_bwd_dq_kernel<HD>
        <<<dim3((a.S + BQ - 1) / BQ, a.H, a.B), THREADS, smem_q, st>>>(
            q_, k_, v_, do_, lse_, D_, static_cast<T*>(dq), a);
  }
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* D, void* dq, void* dk,
             void* dv, int B, int S, int Sk, int H, int KH, int hd,
             const long long* st, float scale, int causal, int window,
             void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0)
    return int(cudaErrorInvalidValue);
  Args a;
  a.B = B; a.S = S; a.Sk = Sk; a.H = H; a.KH = KH;
  a.q_sb = st[0]; a.q_ss = st[1]; a.q_sh = st[2];
  a.k_sb = st[3]; a.k_ss = st[4]; a.k_sh = st[5];
  a.v_sb = st[6]; a.v_ss = st[7]; a.v_sh = st[8];
  a.o_sb = st[9]; a.o_ss = st[10]; a.o_sh = st[11];
  a.do_sb = st[12]; a.do_ss = st[13]; a.do_sh = st[14];
  a.scale = scale; a.causal = causal; a.window = window;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the tensor-core kernels load q, k, v and do 16 bytes at a time
    const int vec[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14};
    for (int i : vec)
      if (st[i] % 8) return int(cudaErrorMisalignedAddress);
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) |
         reinterpret_cast<uintptr_t>(dout)) % 16)
      return int(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, a, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, a, s);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, D, dq, dk, dv, a, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, a, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

#define FLASH_BWD_ENTRY(NAME, T)                                             \
  int NAME(const void* q, const void* k, const void* v, const void* o,       \
           const void* dout, const void* lse, void* D, void* dq, void* dk,   \
           void* dv, int B, int S, int Sk, int H, int KH, int hd,            \
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,   \
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,   \
           long long v_sh, long long o_sb, long long o_ss, long long o_sh,   \
           long long do_sb, long long do_ss, long long do_sh, float scale,   \
           int causal, int window, void* stream) {                           \
    const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,      \
                              v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss,    \
                              do_sh};                                        \
    return dispatch<T>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, Sk, H,    \
                       KH, hd, st, scale, causal, window, stream);           \
  }

FLASH_BWD_ENTRY(flash_bwd_bf16, __nv_bfloat16)
FLASH_BWD_ENTRY(flash_bwd_f32, float)

#undef FLASH_BWD_ENTRY

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
