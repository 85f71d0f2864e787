// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/models/attention.py:211-286, the jnp block-recompute
//           backward of the flash custom VJP (the JAX package has no Pallas
//           backward kernel; its forward is the Pallas kernel that
//           csrc/flash_fwd.cu replaces).
//
// Computes the gradient of causal and/or sliding-window attention with GQA
// from (q, k, v, o, lse, do): q is (B, S, H, hd), o and do (B, S, H, hd_v),
// k (B, Sk, KH, hd) and v (B, Sk, KH, hd_v), with hd_v = hd or MLA's pair
// (hd 192, hd_v 128), all read through their strides (the last dim must be
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
//   * bf16 (training), laid out as csrc/flash_fwd.cu is: TMA loads from
//     the tensors' own strides into mbarrier rings fed by a producer warp,
//     products as wgmma on the tensor cores with fp32 sums (S^T = K Q^T,
//     dP^T = V dO^T, S = Q K^T, dP = dO V^T from shared memory; dV +=
//     P^T dO, dK += dS^T Q, dQ += dS K with the A operand in registers).
//     P^T, dS^T and dS are rounded to bf16 as those A operands and never
//     leave registers (the forward rounds P the same way). Softmax in log2
//     units: the pre-pass writes lse log2 e beside D, and scale log2 e is
//     folded once. Only tiles on the causal diagonal, the window's edge or
//     the ragged edge test the mask (the tile rule, tile_kind below);
//   * fp32: scalar fp32 FMAs out of shared memory (bound by shared-memory
//     issue), which keeps full fp32 accuracy.
//
// Design (the common FlashAttention-2 split, deterministic: no atomics,
// every sum in a fixed order, so two calls give the same bits):
//   * a pre-pass: D = rowsum(do * o) (flash_bwd_dot_kernel: fp32, one warp
//     a (b, s, h) row; flash_bwd_prep_bf16_kernel: bf16, 8 lanes a row,
//     with lse log2 e beside D);
//   * dK/dV: one CTA per (k tile, KV head, b) keeps its K and V in shared
//     memory and dK/dV in registers, and loops over the G query heads of
//     its KV head and, for each, over the 64-row q tiles that meet the
//     causal / window mask of its keys: it recomputes S^T and dP^T for the
//     (k tile x q tile), forms P^T and dS^T, and accumulates dV += P^T dO
//     and dK += dS^T Q. bf16 (flash_bwd_dkdv_wgmma_kernel): 128 keys, two
//     consumer warpgroups of 64 keys each reading the same ring stage of
//     Q/dO/lse/D, and a producer warpgroup; fp32: 64 keys, 256 threads;
//   * dQ: one CTA per (q tile, q head, b) keeps Q, dO, lse and D of its
//     rows and dQ, and loops over the k tiles that meet its mask (the rule
//     of the forward), recomputing S, dP and dS and accumulating dQ += dS
//     K. bf16 (flash_bwd_dq_wgmma_kernel): one consumer warpgroup of 64
//     rows and a producer warp with a ring of K/V tiles, the forward's CTA.
// S and dP are computed twice (once per kernel): 7 products instead of 5,
// the price of no atomics. Tiles that the mask discards entirely are never
// computed; rows >= S and keys >= Sk are masked (p = 0) and not stored.
// Heavy tiles launch first (early k tiles; late q tiles). The bf16 kernels
// serve head dims 32, 64, 80 (64 + 16 column blocks) and 128, and
// MLA's (192, 128) (below); the CTA
// shapes and ring depths were chosen by timing on the card (PERF.md) and
// are compile-time constants below. In the fp32 kernels a thread of the
// 256 owns a 4 x 4 block of each 64 x 64 score tile (rows ty + 16 i, keys
// tx + 16 j) and 4 x hd/16 of each output tile; tiles are fp32 in shared
// memory with odd row strides (hd + 1), so no warp's loads conflict.
//
// MLA's (192, 128) (deepseek-v2-lite's training): every kernel is
// templated on (HD, HDV), the q/k and the v head dims; q and K tiles take
// HD columns, V and dO HDV (in bf16, q and K are 3 column blocks of 128
// bytes, V and dO 2). The bf16 dK/dV kernel cannot hold dK (96 floats a
// thread at 192 columns) beside dV (64), S^T and dP^T (32 each) under its
// 240 registers, so at HD + HDV > 256 its consumers run two passes over
// the same q tiles: dV (S^T, P^T, dV += P^T dO), stored, then dK (S^T and
// dP^T again, dS^T, dK += dS^T Q), stored. The producer streams the ring
// twice; K and V stay in shared memory. That is one more S^T product a
// tile (6 products in dK/dV, 8 in all at this pair), and the sums and
// their order are those of one pass, so the bits do not depend on it.
// The fp32 tiles at (192, 128) take 206,336 bytes in dK/dV and 185,856 in
// dQ.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

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

// HD: the q/k head dim; HDV: the v head dim (Q and K tiles take HD + 1
// floats a row, V and dO HDV + 1)
template <int HD, int HDV>
constexpr size_t dkdv_smem_bytes() {     // K, V, Q, dO, P, dS, lse, D
  return sizeof(float) * (2 * tile_floats<HD>() + 2 * tile_floats<HDV>() +
                          2 * size_t(BQ) * PS + 2 * BQ);
}

template <int HD, int HDV>
constexpr size_t dq_smem_bytes() {       // Q, dO, K, V, dS, lse, D
  return sizeof(float) * (2 * tile_floats<HD>() + 2 * tile_floats<HDV>() +
                          size_t(BQ) * PS + 2 * BQ);
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

// a (4 x 4) block of a b^T over N columns: rows ty + 16 i of a, tx + 16 j
// of b, tiles with row stride N + 1
template <int N>
__device__ __forceinline__ void block_dot(const float* A, const float* Bt,
                                          int ty, int tx, float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < N; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = A[(ty + 16 * i) * (N + 1) + c];
      bv[i] = Bt[(tx + 16 * i) * (N + 1) + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
  }
}

// s = Q K^T (over HD) and dp = dO V^T (over HDV) for this thread's 4 x 4
// block (q rows ty + 16 i, keys tx + 16 j) of the 64 x 64 tile
template <int HD, int HDV>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  block_dot<HD>(Qs, Ks, ty, tx, s);
  block_dot<HDV>(dOs, Vs, ty, tx, dp);
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
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, Args a) {
  constexpr int NJ = HD / 16;              // dK columns a thread
  constexpr int NJV = HDV / 16;            // dV columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + tile_floats<HD>();
  float* Qs = Vs + tile_floats<HDV>();
  float* dOs = Qs + tile_floats<HD>();
  float* Ps = dOs + tile_floats<HDV>();
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* D_s = lse_s + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;          // early keys (most work) first
  const int G = a.H / a.KH;
  load_tile<HD>(Ks, k + b * a.k_sb + kh * a.k_sh, a.k_ss, k0, a.Sk);
  load_tile<HDV>(Vs, v + b * a.v_sb + kh * a.v_sh, a.v_ss, k0, a.Sk);

  // the q tiles whose rows may see one of keys k0 .. k_last
  const int k_last = min(k0 + BK, a.Sk) - 1;
  const int it_lo = a.causal ? k0 / BQ : 0;
  int it_hi = (a.S + BQ - 1) / BQ - 1;
  if (a.window) it_hi = min(it_hi, (k_last + a.window - 1) / BQ);

  float dk_acc[4][NJ], dv_acc[4][NJV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) dv_acc[i][j] = 0.f;
  }

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
      load_tile<HDV>(dOs, dob, a.do_ss, q0, a.S);
      load_rows(lse_s, D_s, lb, Db, q0, a.S);
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<HD, HDV>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
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
        for (int j = 0; j < NJV; ++j) {
          const float dov = dOs[r * (HDV + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float qv = Qs[r * (HD + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
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
    for (int j = 0; j < NJ; ++j) dk[row * HD + tx + 16 * j] = dk_acc[i][j];
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      dv[row * HDV + tx + 16 * j] = dv_acc[i][j];
  }
}

// one CTA per (q tile, q head, b): dQ of its 64 rows
template <int HD, int HDV>
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
  float* Ks = dOs + tile_floats<HDV>();
  float* Vs = Ks + tile_floats<HD>();
  float* dSs = Vs + tile_floats<HDV>();
  float* lse_s = dSs + BQ * PS;
  float* D_s = lse_s + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // late rows first
  const float* kb = k + b * a.k_sb + kh * a.k_sh;
  const float* vb = v + b * a.v_sb + kh * a.v_sh;
  load_tile<HD>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
  load_tile<HDV>(dOs, dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, a.S);
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
    load_tile<HDV>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<HD, HDV>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
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
// bf16: TMA-fed tile rings and wgmma (the layout of csrc/flash_fwd.cu)
// ---------------------------------------------------------------------------
//
// The helpers (TMA, mbarriers, wgmma, column blocks, fragment layouts) are
// csrc/hopper.cuh's. P^T, dS^T and dS are packed from their accumulators
// straight into the register A operands of the second products, so they
// never leave registers.
//
// Every bf16 tile in shared memory is 64 rows (q rows or keys) of hd
// columns, written by TMA from the tensor's own strides, in column blocks
// of one swizzle width each (a row of 128, 64 or 32 bytes): hd 32 = 32;
// 64 = 64; 80 = 64 + 16; 128 = 64 + 64; 192 = 64 + 64 + 64. Block c of a
// tile sits at byte
// 64 * off(c) * 2. As a K-major operand (the first products: Q, K, V, dO
// with hd the reduced dimension) a k-step is 16 columns inside a block; as
// the MN-major B operand (the second products: dO, Q, K with the rows
// reduced) a k-step is 16 rows of every block.

constexpr int T_ROWS = 64;                 // rows of a tile, and of a wgmma M
constexpr float LOG2E = 1.4426950408889634f;

// The CTA shapes and ring depths, chosen by timing on the card (PERF.md):
//   * dK/dV: 128 keys, two consumer warpgroups of 64 keys each and a
//     producer warpgroup (one thread of it issues the loads), so that
//     setmaxnreg can move registers from it to the consumers: 3 x 128
//     threads launch at 168 registers each, then hold 24 (producer) and
//     240 (consumers); a ring of 2 Q/dO/lse/D stages;
//   * dQ: 64 rows, one consumer warpgroup and a producer warp (the
//     forward's CTA); a ring of 3 K/V stages.
constexpr int KV_KEYS = 2 * T_ROWS;
constexpr int KV_THREADS = 3 * 128;
constexpr int KV_STAGES = 2;
constexpr int Q_THREADS = 128 + 32;
constexpr int Q_STAGES = 3;

// The tile rule, mirrored by tile_kinds in kernels/flash_attention/ref.py:
// a tile of q rows q0 .. q0 + nq - 1 and keys k0 .. k0 + nk - 1 is
// skipped when no (row, key) pair in it is allowed (rows >= S and keys >=
// Sk are never allowed), interior when every pair is allowed and in range
// (no mask test), and an edge otherwise (each pair tested).
enum TileKind { TILE_SKIPPED = 0, TILE_INTERIOR = 1, TILE_EDGE = 2 };

__host__ __device__ __forceinline__ int tile_kind(const Args& a, int q0,
                                                  int nq, int k0, int nk) {
  const int q_last = (q0 + nq < a.S ? q0 + nq : a.S) - 1;
  const int k_last = (k0 + nk < a.Sk ? k0 + nk : a.Sk) - 1;
  if (q_last < q0 || k_last < k0) return TILE_SKIPPED;
  if (a.causal && k0 > q_last) return TILE_SKIPPED;
  if (a.window && k_last <= q0 - a.window) return TILE_SKIPPED;
  const bool interior = q0 + nq <= a.S && k0 + nk <= a.Sk &&
                        (!a.causal || k0 + nk - 1 <= q0) &&
                        (!a.window || k0 > q0 + nq - 1 - a.window);
  return interior ? TILE_INTERIOR : TILE_EDGE;
}

struct TmaMaps {                           // one box shape per column block
  CUtensorMap q[3], k[3], v[3], dout[3];
};

// a plain copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the packed A operands of products still in flight stay where they are
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (*p)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int HD>
struct Tile {
  using C = Cols<HD>;
  static constexpr int BYTES = T_ROWS * HD * 2;

  // every column block of 64 rows from (row, head, b) of a map
  __device__ static void load(uint32_t tile, const CUtensorMap* maps,
                              uint32_t bar, int head, int row, int b) {
#pragma unroll
    for (int c = 0; c < C::NB; ++c)
      tma_load_4d(tile + T_ROWS * C::off(c) * 2, &maps[c], bar, C::off(c),
                  head, row, b);
  }
};

// d (64 x 64) = a b^T over hd: both tiles K-major, 16 columns a step
template <int HD>
__device__ __forceinline__ void ss_product(float* d, uint32_t a, uint32_t b) {
  using C = Cols<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = (16 * kk) / 64;
    const int rb = C::width(c) * 2;
    const uint32_t at = T_ROWS * C::off(c) * 2 + (16 * kk - C::off(c)) * 2;
    wgmma_ss_n64(d, gmma_desc(a + at, rb), gmma_desc(b + at, rb), kk > 0);
  }
}

// acc (64 x hd) += p (64 x 64, packed bf16 registers) b (a tile read
// MN-major, 16 of its rows a step), one product a column block
template <int HD>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t (*p)[4],
                                           uint32_t b) {
  using C = Cols<HD>;
#pragma unroll
  for (int kc = 0; kc < T_ROWS / 16; ++kc) {
    wgmma_rs<C::width(0)>(acc, p[kc],
                          gmma_desc(b + 16 * kc * C::width(0) * 2,
                                    C::width(0) * 2));
    if constexpr (C::NB >= 2)
      wgmma_rs<C::width(1)>(
          acc + C::off(1) / 2, p[kc],
          gmma_desc(b + T_ROWS * C::off(1) * 2 + 16 * kc * C::width(1) * 2,
                    C::width(1) * 2));
    if constexpr (C::NB == 3)
      wgmma_rs<C::width(2)>(
          acc + C::off(2) / 2, p[kc],
          gmma_desc(b + T_ROWS * C::off(2) * 2 + 16 * kc * C::width(2) * 2,
                    C::width(2) * 2));
  }
}

// the A fragments of a 64 x 64 accumulator, 16 columns each
__device__ __forceinline__ void pack_a(uint32_t (*p)[4], const float* s) {
#pragma unroll
  for (int kc = 0; kc < T_ROWS / 16; ++kc) {
    const float* s0 = s + 8 * kc;          // columns 16kc .. 16kc + 7
    const float* s1 = s0 + 4;              // columns 16kc + 8 .. 16kc + 15
    p[kc][0] = pack_bf16(s0[0], s0[1]);
    p[kc][1] = pack_bf16(s0[2], s0[3]);
    p[kc][2] = pack_bf16(s1[0], s1[1]);
    p[kc][3] = pack_bf16(s1[2], s1[3]);
  }
}

// a 64 x hd accumulator as bf16 rows row_a and row_a + 8 (each if < n) of
// base, rows rs elements apart
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float* acc, int row_a,
                                           int n, int t) {
  using C = Cols<HD>;
#pragma unroll
  for (int c = 0; c < C::NB; ++c) {
#pragma unroll
    for (int j = 0; j < C::width(c) / 8; ++j) {
      const float* r = acc + C::off(c) / 2 + 4 * j;
      const int col = C::off(c) + 8 * j + 2 * t;
      if (row_a < n)
        *reinterpret_cast<__nv_bfloat162*>(base + row_a * rs + col) =
            __floats2bfloat162_rn(r[0], r[1]);
      if (row_a + 8 < n)
        *reinterpret_cast<__nv_bfloat162*>(base + (row_a + 8) * rs + col) =
            __floats2bfloat162_rn(r[2], r[3]);
    }
  }
}

// HD: the q/k head dim (Q and K tiles); HDV: the v head dim (V and dO)
template <int HD, int HDV>
constexpr size_t dkdv_wg_smem_bytes() {    // K, V; the ring; barriers
  return 1024 + size_t(2) * (Tile<HD>::BYTES + Tile<HDV>::BYTES) +
         size_t(KV_STAGES) * (Tile<HD>::BYTES + Tile<HDV>::BYTES + 1024) +
         8 * (2 * KV_STAGES + 1);
}

template <int HD, int HDV>
constexpr size_t dq_wg_smem_bytes() {      // Q, dO; the ring; barriers
  return 1024 + size_t(Tile<HD>::BYTES + Tile<HDV>::BYTES) +
         size_t(Q_STAGES) * (Tile<HD>::BYTES + Tile<HDV>::BYTES) +
         8 * (2 * Q_STAGES + 1);
}

// the dK/dV consumers' passes: both sums in one pass, or (where dK and dV
// together do not fit the registers, HD + HDV > 256) dV, then dK
enum DkdvPass { PASS_BOTH = 0, PASS_DV = 1, PASS_DK = 2 };

// P^T of a 64-key x 64-row tile in place of S^T: p = exp2(s scale
// log2 e - lse log2 e). This thread's keys are its rows key_a, key_a + 8,
// its q rows the columns q0 + 8j + 2t (+1), whose lse log2 e l2 holds. On
// an edge tile each pair is tested.
template <bool EDGE>
__device__ __forceinline__ void probs_t(const Args& a, float* st,
                                        const float* l2, float scale2,
                                        int q0, int key_a, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(st[4 * j + e] * scale2 - ((e & 1) ? lv.y : lv.x));
      if (EDGE && !allowed(a, q0 + 8 * j + 2 * t + (e & 1),
                           key_a + 8 * (e >> 1)))
        p = 0.f;
      st[4 * j + e] = p;
    }
  }
}

// dS^T = P^T (dP^T - D) scale in place of dP^T (D of the columns' rows)
__device__ __forceinline__ void dgrad_t(const float* pt, float* dpt,
                                        const float* Dr, float scale,
                                        int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dv = *reinterpret_cast<const float2*>(Dr + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * j + e] = pt[4 * j + e] *
                       (dpt[4 * j + e] - ((e & 1) ? dv.y : dv.x)) * scale;
  }
}

// P of a 64-row x 64-key tile in place of S: this thread's q rows are
// row_a, row_a + 8 (their lse log2 e in l2), its keys the columns
// k0 + 8j + 2t (+1)
template <bool EDGE>
__device__ __forceinline__ void probs(const Args& a, float* s,
                                      const float* l2, float scale2,
                                      int row_a, int k0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[4 * j + e] * scale2 - l2[e >> 1]);
      if (EDGE && !allowed(a, row_a + 8 * (e >> 1),
                           k0 + 8 * j + 2 * t + (e & 1)))
        p = 0.f;
      s[4 * j + e] = p;
    }
}

// the bf16 pre-pass: D = rowsum(do * o) and lse log2 e, written (B, H, ld)
// with rows S .. ld - 1 zero, so that a tile's rows are one aligned
// 256-byte copy; 8 lanes a (b, s, h) row, 16 bytes a load (the wrapper
// makes the rows of o and do 16-byte aligned)
__global__ void flash_bwd_prep_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           float* __restrict__ D,
                                           float* __restrict__ L2, Args a,
                                           int hd, int ld) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  const bool valid = row < (long long)a.B * ld * a.H;
  const int h = int(row % a.H);
  const int s = int((row / a.H) % ld);
  const int b = int(row / ((long long)a.H * ld));
  float acc = 0.f;
  if (valid && s < a.S) {
    const __nv_bfloat16* ob = o + b * a.o_sb + s * a.o_ss + h * a.o_sh;
    const __nv_bfloat16* db = dout + b * a.do_sb + s * a.do_ss + h * a.do_sh;
    for (int d = 8 * sub; d < hd; d += 64) {
      const uint4 x = *reinterpret_cast<const uint4*>(ob + d);
      const uint4 y = *reinterpret_cast<const uint4*>(db + d);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xf = __bfloat1622float2(xp[i]);
        const float2 yf = __bfloat1622float2(yp[i]);
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && sub == 0) {
    const long long out = ((long long)b * a.H + h) * ld + s;
    D[out] = s < a.S ? acc : 0.f;
    L2[out] = s < a.S ? lse[((long long)b * a.H + h) * a.S + s] * LOG2E : 0.f;
  }
}

// one consumer warpgroup's pass over every q tile of the ring (its
// index i runs on across passes): S^T = K Q^T and, for dK, dP^T = V dO^T
// (SS), P^T and dS^T in registers, then dV += P^T dO and/or dK += dS^T Q
// (RS)
template <int HD, int HDV, int PASS>
__device__ __forceinline__ void dkdv_pass(
    const Args& a, float* dk_acc, float* dv_acc, uint32_t my_k,
    uint32_t my_v, uint32_t ring, const unsigned char* smem_base,
    uint32_t bars, int G, int it_lo, int it_hi, int kw, int key_a, int t,
    int lane, int& i) {
  constexpr int STAGE = Tile<HD>::BYTES + Tile<HDV>::BYTES + 1024;
  const float scale2 = a.scale * LOG2E;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (KV_STAGES + s); };
  for (int gh = 0; gh < G; ++gh) {
    for (int it = it_lo; it <= it_hi; ++it, ++i) {
      const int s = i % KV_STAGES;
      const int q0 = it * T_ROWS;
      mbar_wait(full(s), (i / KV_STAGES) & 1);
      __syncwarp();                        // wgmma wants converged warps
      const int kind = tile_kind(a, q0, T_ROWS, kw, T_ROWS);
      if (kind != TILE_SKIPPED) {
        const uint32_t q_t = ring + s * STAGE;
        const uint32_t do_t = q_t + Tile<HD>::BYTES;
        const float* l2 = reinterpret_cast<const float*>(
            smem_base + s * STAGE + Tile<HD>::BYTES + Tile<HDV>::BYTES);
        float st[32], dpt[32];
#pragma unroll
        for (int n = 0; n < 32; ++n) st[n] = dpt[n] = 0.f;
        wgmma_fence();
        ss_product<HD>(st, my_k, q_t);     // S^T = K Q^T
        wgmma_commit();
        if constexpr (PASS != PASS_DV) {
          ss_product<HDV>(dpt, my_v, do_t);  // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs<32>(st);
        if (kind == TILE_EDGE)
          probs_t<true>(a, st, l2, scale2, q0, key_a, t);
        else
          probs_t<false>(a, st, l2, scale2, q0, key_a, t);
        uint32_t pa[4][4], sa[4][4];
        if constexpr (PASS == PASS_DV) {
          pack_a(pa, st);
        } else {
          wgmma_wait<0>();
          fence_regs<32>(dpt);
          dgrad_t(st, dpt, l2 + 64, a.scale, t);
          if constexpr (PASS == PASS_BOTH) pack_a(pa, st);
          pack_a(sa, dpt);
        }
        wgmma_fence();
        if constexpr (PASS != PASS_DK)
          rs_product<HDV>(dv_acc, pa, do_t);  // dV += P^T dO
        if constexpr (PASS != PASS_DV)
          rs_product<HD>(dk_acc, sa, q_t);    // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (PASS != PASS_DK) fence_regs<HDV / 2>(dv_acc);
        if constexpr (PASS != PASS_DV) fence_regs<HD / 2>(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // the stage may be refilled
    }
  }
}

// one CTA per (128 keys, KV head, b): two consumer warpgroups of 64 keys
// and a producer warpgroup. K and V of the CTA's keys arrive once; the
// producer streams, for each of the G query heads, the 64-row q tiles that
// meet the keys' mask through a ring of KV_STAGES stages (Q, dO, and the
// rows' lse log2 e and D), once a pass. Each warpgroup runs dkdv_pass on
// its 64 keys (both warpgroups read the same stage); at HD + HDV > 256 it
// runs the dV pass and the dK pass one after the other, so that only one
// of the two accumulators is live at a time.
template <int HD, int HDV>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ TmaMaps maps,
                            const float* __restrict__ L2,
                            const float* __restrict__ Dd,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, const Args a,
                            int s_pad) {
  constexpr int TBK = Tile<HD>::BYTES;     // a Q or K tile
  constexpr int TBV = Tile<HDV>::BYTES;    // a dO or V tile
  constexpr int STAGE = TBK + TBV + 1024;  // Q, dO, lse log2 e and D
  constexpr bool TWO_PASS = HD + HDV > 256;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + 2 * TBK;
  const uint32_t ring = v_s + 2 * TBV;
  const uint32_t bars = ring + KV_STAGES * STAGE;
  const uint32_t kv_bar = bars + 16 * KV_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (KV_STAGES + s); };
  const unsigned char* smem_base =
      smem_raw + (ring - smem_u32(smem_raw));   // generic view of the ring

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = blockIdx.y, b = blockIdx.z;
  // early keys (the most q tiles) first
  const int k0 = blockIdx.x * KV_KEYS;
  const int G = a.H / a.KH;
  // the q tiles that meet the mask of keys k0 .. k_last (the tile rule at
  // 64 rows x the CTA's keys: every other tile is skipped)
  const int k_last = min(k0 + KV_KEYS, a.Sk) - 1;
  const int it_lo = a.causal ? k0 / T_ROWS : 0;
  int it_hi = (a.S + T_ROWS - 1) / T_ROWS - 1;
  if (a.window) it_hi = min(it_hi, (k_last + a.window - 1) / T_ROWS);

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);              // one arrival a consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: K and V, then Q/dO/lse/D stages as the ring frees them
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * (TBK + TBV));
      for (int w = 0; w < 2; ++w) {
        Tile<HD>::load(k_s + w * TBK, maps.k, kv_bar, kh, k0 + T_ROWS * w, b);
        Tile<HDV>::load(v_s + w * TBV, maps.v, kv_bar, kh, k0 + T_ROWS * w,
                        b);
      }
      int i = 0;
      for (int pass = 0; pass < (TWO_PASS ? 2 : 1); ++pass) {
        for (int gh = 0; gh < G; ++gh) {
          const int h = kh * G + gh;
          const float* l2 = L2 + ((long long)b * a.H + h) * s_pad;
          const float* dd = Dd + ((long long)b * a.H + h) * s_pad;
          for (int it = it_lo; it <= it_hi; ++it, ++i) {
            const int s = i % KV_STAGES;
            if (i >= KV_STAGES)
              mbar_wait(empty(s), ((i / KV_STAGES) - 1) & 1);
            mbar_expect_tx(full(s), TBK + TBV + 512);
            const uint32_t st = ring + s * STAGE;
            Tile<HD>::load(st, maps.q, full(s), h, it * T_ROWS, b);
            Tile<HDV>::load(st + TBK, maps.dout, full(s), h, it * T_ROWS, b);
            bulk_load(st + TBK + TBV, l2 + it * T_ROWS, 256, full(s));
            bulk_load(st + TBK + TBV + 256, dd + it * T_ROWS, 256, full(s));
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + T_ROWS * wg;       // this warpgroup's first key
    const int key_a = kw + 16 * wi + g;    // this thread's two keys
    const uint32_t my_k = k_s + wg * TBK, my_v = v_s + wg * TBV;
    mbar_wait(kv_bar, 0);
    const long long base = (long long)b * a.Sk * a.KH + kh;   // row, head
    int i = 0;
    if constexpr (TWO_PASS) {
      {
        float dv_acc[HDV / 2];
#pragma unroll
        for (int n = 0; n < HDV / 2; ++n) dv_acc[n] = 0.f;
        dkdv_pass<HD, HDV, PASS_DV>(a, nullptr, dv_acc, my_k, my_v, ring,
                                    smem_base, bars, G, it_lo, it_hi, kw,
                                    key_a, t, lane, i);
        store_rows<HDV>(dv + base * HDV, (long long)a.KH * HDV, dv_acc,
                        key_a, a.Sk, t);
      }
      {
        float dk_acc[HD / 2];
#pragma unroll
        for (int n = 0; n < HD / 2; ++n) dk_acc[n] = 0.f;
        dkdv_pass<HD, HDV, PASS_DK>(a, dk_acc, nullptr, my_k, my_v, ring,
                                    smem_base, bars, G, it_lo, it_hi, kw,
                                    key_a, t, lane, i);
        store_rows<HD>(dk + base * HD, (long long)a.KH * HD, dk_acc, key_a,
                       a.Sk, t);
      }
    } else {
      float dk_acc[HD / 2], dv_acc[HDV / 2];
#pragma unroll
      for (int n = 0; n < HD / 2; ++n) dk_acc[n] = 0.f;
#pragma unroll
      for (int n = 0; n < HDV / 2; ++n) dv_acc[n] = 0.f;
      dkdv_pass<HD, HDV, PASS_BOTH>(a, dk_acc, dv_acc, my_k, my_v, ring,
                                    smem_base, bars, G, it_lo, it_hi, kw,
                                    key_a, t, lane, i);
      store_rows<HD>(dk + base * HD, (long long)a.KH * HD, dk_acc, key_a,
                     a.Sk, t);
      store_rows<HDV>(dv + base * HDV, (long long)a.KH * HDV, dv_acc, key_a,
                      a.Sk, t);
    }
  }
}

// one CTA per (64 q rows, q head, b): one consumer warpgroup and a
// producer warp. Q, dO of the CTA's rows arrive once (lse log2 e and D of
// a thread's two rows are read into registers); the producer keeps a ring
// of Q_STAGES K/V tiles of 64 keys in flight. The warpgroup computes
// S = Q K^T and dP = dO V^T (SS), dS in registers, then dQ += dS K (RS).
template <int HD, int HDV>
__global__ void __launch_bounds__(Q_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ TmaMaps maps,
                          const float* __restrict__ L2,
                          const float* __restrict__ Dd,
                          __nv_bfloat16* __restrict__ dq, const Args a,
                          int s_pad) {
  constexpr int TBK = Tile<HD>::BYTES;     // a Q or K tile
  constexpr int TBV = Tile<HDV>::BYTES;    // a dO or V tile
  constexpr int STAGE = TBK + TBV;         // K, V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + TBK;
  const uint32_t ring = do_s + TBV;
  const uint32_t bars = ring + Q_STAGES * STAGE;
  const uint32_t q_bar = bars + 16 * Q_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (Q_STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  // late rows (the most k tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T_ROWS;
  // the k tiles that meet the mask of rows q0 .. q_last
  const int q_last = min(q0 + T_ROWS, a.S) - 1;
  int j_lo = 0, j_hi = (a.Sk + T_ROWS - 1) / T_ROWS - 1;
  if (a.causal) j_hi = min(j_hi, q_last / T_ROWS);
  if (a.window && q0 - a.window + 1 > 0) j_lo = (q0 - a.window + 1) / T_ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(q_bar, TBK + TBV);
      Tile<HD>::load(q_s, maps.q, q_bar, h, q0, b);
      Tile<HDV>::load(do_s, maps.dout, q_bar, h, q0, b);
      for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
        const int s = i % Q_STAGES;
        if (i >= Q_STAGES) mbar_wait(empty(s), ((i / Q_STAGES) - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t kt = ring + s * STAGE;
        Tile<HD>::load(kt, maps.k, full(s), kh, jt * T_ROWS, b);
        Tile<HDV>::load(kt + TBK, maps.v, full(s), kh, jt * T_ROWS, b);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int row_a = q0 + 16 * warp + g;  // this thread's two rows
    const float scale2 = a.scale * LOG2E;
    const float* l2b = L2 + ((long long)b * a.H + h) * s_pad;
    const float* ddb = Dd + ((long long)b * a.H + h) * s_pad;
    float l2[2], Dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;       // rows past S: padded zeros,
      l2[r] = row < s_pad ? l2b[row] : 0.f;  // masked on edge tiles
      Dr[r] = row < s_pad ? ddb[row] : 0.f;
    }

    float dq_acc[HD / 2];
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) dq_acc[n] = 0.f;
    // dQ += dS K of a tile runs on while the next tile's S and dP are
    // issued: its stage is released, and its A operand may be
    // overwritten, only after the wait that follows (timed on the card
    // against waiting at once: faster in dQ at hd 80 and 128, no slower
    // at 64; slower in dK/dV, which waits at once)
    uint32_t sa[4][4] = {};
    int pending = -1;                      // the stage it reads
    mbar_wait(q_bar, 0);

    for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
      const int s = i % Q_STAGES;
      const int k0 = jt * T_ROWS;
      mbar_wait(full(s), (i / Q_STAGES) & 1);
      __syncwarp();
      const int kind = tile_kind(a, q0, T_ROWS, k0, T_ROWS);
      if (kind == TILE_SKIPPED) {
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs<HD / 2>(dq_acc);
          fence_a<4>(sa);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(pending));
          pending = -1;
        }
        if (lane == 0) mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_t = ring + s * STAGE, v_t = k_t + TBK;
      float sc[32], dp[32];
#pragma unroll
      for (int n = 0; n < 32; ++n) sc[n] = dp[n] = 0.f;
      wgmma_fence();
      ss_product<HD>(sc, q_s, k_t);        // S = Q K^T
      wgmma_commit();
      ss_product<HDV>(dp, do_s, v_t);      // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();                     // S and the last tile's dQ
      fence_regs<32>(sc);
      fence_regs<HD / 2>(dq_acc);
      fence_a<4>(sa);
      if (pending >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(pending));
      }
      if (kind == TILE_EDGE)
        probs<true>(a, sc, l2, scale2, row_a, k0, t);
      else
        probs<false>(a, sc, l2, scale2, row_a, k0, t);
      wgmma_wait<0>();
      fence_regs<32>(dp);
#pragma unroll
      for (int n = 0; n < 32; ++n)         // dS = P (dP - D) scale
        sc[n] = sc[n] * (dp[n] - Dr[(n >> 1) & 1]) * a.scale;
      pack_a(sa, sc);
      wgmma_fence();
      rs_product<HD>(dq_acc, sa, k_t);     // dQ += dS K
      wgmma_commit();
      fence_regs<HD / 2>(dq_acc);
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs<HD / 2>(dq_acc);
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(pending));
    }

    const long long rs = (long long)a.H * HD;
    store_rows<HD>(dq + ((long long)b * a.S * a.H + h) * HD, rs, dq_acc,
                   row_a, a.S, t);
  }
}

// ---------------------------------------------------------------------------
// launch: D (and lse log2 e), then dK/dV, then dQ, in order on one stream
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute for dynamic shared memory above 48 KB, once per
// kernel instance, device and size (the largest size granted is kept)
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static std::mutex lock;
  static int granted[64];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (dev < 64 && granted[dev] >= int(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < 64) granted[dev] = int(bytes);
  return err;
}

// D = rowsum(do * o) of the fp32 kernels: (B, H, S)
cudaError_t launch_dot_f32(const void* o, const void* dout, float* D,
                           const Args& a, int hd, cudaStream_t st) {
  constexpr int ROWS_PER_CTA = 8;          // warps of the D pre-pass
  const long long rows = (long long)a.B * a.S * a.H;
  flash_bwd_dot_kernel<float><<<unsigned((rows + ROWS_PER_CTA - 1) /
                                         ROWS_PER_CTA),
                                32 * ROWS_PER_CTA, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), D, a,
      hd);
  return cudaGetLastError();
}

template <int HD, int HDV>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* D, void* dq, void* dk,
               void* dv, const Args& a, cudaStream_t st) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* D_ = static_cast<float*>(D);
  cudaError_t err = launch_dot_f32(o, dout, D_, a, HDV, st);
  if (err != cudaSuccess) return int(err);

  const size_t smem_kv = dkdv_smem_bytes<HD, HDV>();
  err = allow_smem<flash_bwd_dkdv_kernel<HD, HDV>>(smem_kv);
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkdv_kernel<HD, HDV>
      <<<dim3((a.Sk + BK - 1) / BK, a.KH, a.B), THREADS, smem_kv, st>>>(
          q_, k_, v_, do_, lse_, D_, static_cast<float*>(dk),
          static_cast<float*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t smem_q = dq_smem_bytes<HD, HDV>();
  err = allow_smem<flash_bwd_dq_kernel<HD, HDV>>(smem_q);
  if (err != cudaSuccess) return int(err);
  flash_bwd_dq_kernel<HD, HDV>
      <<<dim3((a.S + BQ - 1) / BQ, a.H, a.B), THREADS, smem_q, st>>>(
          q_, k_, v_, do_, lse_, D_, static_cast<float*>(dq), a);
  return int(cudaGetLastError());
}

// D is the wrapper's scratch of 2 B H s_pad floats: D, then lse log2 e
template <int HD, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* D, void* dq,
                void* dk, void* dv, const Args& a, cudaStream_t st) {
  using C = Cols<HD>;                      // q and K
  using CV = Cols<HDV>;                    // V and dO
  const int s_pad = (a.S + T_ROWS - 1) / T_ROWS * T_ROWS;
  float* Dd = static_cast<float*>(D);
  float* L2 = Dd + (size_t)a.B * a.H * s_pad;
  const long long lanes = 8LL * a.B * a.H * s_pad;
  flash_bwd_prep_bf16_kernel<<<unsigned((lanes + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), Dd, L2, a, HDV, s_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  TmaMaps maps;
  for (int c = 0; c < 3; ++c) {            // blocks past NB repeat block 0
    const int w = C::width(c < C::NB ? c : 0);
    const int wv = CV::width(c < CV::NB ? c : 0);
    if (!make_map(encode, &maps.q[c], q, HD, a.H, a.S, a.B, a.q_sh, a.q_ss,
                  a.q_sb, w, T_ROWS) ||
        !make_map(encode, &maps.dout[c], dout, HDV, a.H, a.S, a.B, a.do_sh,
                  a.do_ss, a.do_sb, wv, T_ROWS) ||
        !make_map(encode, &maps.k[c], k, HD, a.KH, a.Sk, a.B, a.k_sh, a.k_ss,
                  a.k_sb, w, T_ROWS) ||
        !make_map(encode, &maps.v[c], v, HDV, a.KH, a.Sk, a.B, a.v_sh,
                  a.v_ss, a.v_sb, wv, T_ROWS))
      return int(cudaErrorInvalidValue);
  }
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  __nv_bfloat16* dq_ = static_cast<__nv_bfloat16*>(dq);

  const size_t smem_kv = dkdv_wg_smem_bytes<HD, HDV>();
  err = allow_smem<flash_bwd_dkdv_wgmma_kernel<HD, HDV>>(smem_kv);
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkdv_wgmma_kernel<HD, HDV>
      <<<dim3((a.Sk + KV_KEYS - 1) / KV_KEYS, a.KH, a.B), KV_THREADS, smem_kv,
         st>>>(maps, L2, Dd, dk_, dv_, a, s_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t smem_q = dq_wg_smem_bytes<HD, HDV>();
  err = allow_smem<flash_bwd_dq_wgmma_kernel<HD, HDV>>(smem_q);
  if (err != cudaSuccess) return int(err);
  flash_bwd_dq_wgmma_kernel<HD, HDV>
      <<<dim3((a.S + T_ROWS - 1) / T_ROWS, a.H, a.B), Q_THREADS, smem_q,
         st>>>(
          maps, L2, Dd, dq_, a, s_pad);
  return int(cudaGetLastError());
}

// the instance for (hd, hd_v): one head dim for q, k and v, or MLA's
// (192, 128)
template <template <int, int> class F, typename... Ts>
int by_dims(int hd, int hd_v, Ts... xs) {
  if (hd == hd_v) {
    switch (hd) {
      case 32: return F<32, 32>::run(xs...);
      case 64: return F<64, 64>::run(xs...);
      case 80: return F<80, 80>::run(xs...);
      case 128: return F<128, 128>::run(xs...);
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (hd == 192 && hd_v == 128) return F<192, 128>::run(xs...);
  return int(cudaErrorInvalidValue);
}

template <int HD, int HDV>
struct LaunchBf16 {
  template <typename... Ts>
  static int run(Ts... xs) { return launch_bf16<HD, HDV>(xs...); }
};

template <int HD, int HDV>
struct LaunchF32 {
  template <typename... Ts>
  static int run(Ts... xs) { return launch_f32<HD, HDV>(xs...); }
};

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* D, void* dq, void* dk,
             void* dv, int B, int S, int Sk, int H, int KH, int hd, int hd_v,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // TMA reads q, k, v and do, the pre-pass o and do 16 bytes at a time:
    // 16-byte aligned base addresses and strides
    for (int i = 0; i < 15; ++i)
      if (st[i] % 8) return int(cudaErrorMisalignedAddress);
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
         reinterpret_cast<uintptr_t>(dout)) % 16)
      return int(cudaErrorMisalignedAddress);
    return by_dims<LaunchBf16>(hd, hd_v, q, k, v, o, dout, lse, D, dq, dk,
                               dv, a, s);
  } else {
    return by_dims<LaunchF32>(hd, hd_v, q, k, v, o, dout, lse, D, dq, dk,
                              dv, a, s);
  }
}

// the bf16 kernels' CTAs: out = {dK/dV threads, shared-memory bytes, CTAs
// an SM can hold, registers a thread at launch, local (spill) bytes a
// thread; dQ the same}. The dK/dV consumers raise their registers to 240
// with setmaxnreg after launch.
template <int HD, int HDV>
struct PlanBf16 {
  static int run(int* out) {
    const size_t kv = dkdv_wg_smem_bytes<HD, HDV>();
    const size_t qs = dq_wg_smem_bytes<HD, HDV>();
    out[0] = KV_THREADS;
    out[1] = int(kv);
    out[5] = Q_THREADS;
    out[6] = int(qs);
    cudaError_t err = allow_smem<flash_bwd_dkdv_wgmma_kernel<HD, HDV>>(kv);
    if (err == cudaSuccess)
      err = allow_smem<flash_bwd_dq_wgmma_kernel<HD, HDV>>(qs);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], flash_bwd_dkdv_wgmma_kernel<HD, HDV>, KV_THREADS, kv);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[7], flash_bwd_dq_wgmma_kernel<HD, HDV>, Q_THREADS, qs);
    cudaFuncAttributes fa;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, flash_bwd_dkdv_wgmma_kernel<HD, HDV>);
    if (err == cudaSuccess) {
      out[3] = fa.numRegs;
      out[4] = int(fa.localSizeBytes);
      err = cudaFuncGetAttributes(&fa, flash_bwd_dq_wgmma_kernel<HD, HDV>);
    }
    if (err == cudaSuccess) {
      out[8] = fa.numRegs;
      out[9] = int(fa.localSizeBytes);
    }
    return int(err);
  }
};

}  // namespace

extern "C" {

#define FLASH_BWD_ENTRY(NAME, T)                                             \
  int NAME(const void* q, const void* k, const void* v, const void* o,       \
           const void* dout, const void* lse, void* D, void* dq, void* dk,   \
           void* dv, int B, int S, int Sk, int H, int KH, int hd, int hd_v,  \
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,   \
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,   \
           long long v_sh, long long o_sb, long long o_ss, long long o_sh,   \
           long long do_sb, long long do_ss, long long do_sh, float scale,   \
           int causal, int window, void* stream) {                           \
    const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,      \
                              v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss,    \
                              do_sh};                                        \
    return dispatch<T>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, Sk, H,    \
                       KH, hd, hd_v, st, scale, causal, window, stream);     \
  }

FLASH_BWD_ENTRY(flash_bwd_bf16, __nv_bfloat16)
FLASH_BWD_ENTRY(flash_bwd_f32, float)

#undef FLASH_BWD_ENTRY

// the bf16 kernels' CTAs at these head dims (PlanBf16), for reports
int flash_bwd_bf16_plan(int hd, int hd_v, int* out) {
  return by_dims<PlanBf16>(hd, hd_v, out);
}

// the tile rule as the bf16 kernels apply it, for tests against
// ref.tile_kinds: out (ceil(S / nq) x ceil(Sk / nk) bytes, row-major) gets
// the kind of each tile of nq q rows x nk keys
int flash_bwd_tile_kinds(int S, int Sk, int nq, int nk, int causal,
                         int window, signed char* out) {
  if (S <= 0 || Sk <= 0 || nq <= 0 || nk <= 0)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.S = S; a.Sk = Sk; a.causal = causal; a.window = window;
  const int tq = (S + nq - 1) / nq, tk = (Sk + nk - 1) / nk;
  for (int i = 0; i < tq; ++i)
    for (int j = 0; j < tk; ++j)
      out[i * tk + j] = static_cast<signed char>(
          tile_kind(a, i * nq, nq, j * nk, nk));
  return 0;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
