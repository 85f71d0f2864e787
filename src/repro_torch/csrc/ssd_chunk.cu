// Mamba2 SSD intra-chunk step for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py : ssd_chunk_call
//           (Pallas body _ssd_chunk_kernel).
//
// For every (batch, chunk of cl tokens, head h) it computes, in fp32 (cs in
// fp64, see below):
//   cs      = cumsum(dt * A),  A = -exp(A_log[h])                    (cl)
//   y_diag  = (C B^T ⊙ L) (x dt),  L = exp(cs_i - cs_j) for j <= i   (cl, hp)
//   states  = B^T (exp(total - cs) ⊙ x dt)^T,  total = cs[cl - 1]    (hp, ns)
//   exp(cs) and exp(total).
// L is the exponential of the difference, with the upper triangle masked
// before the exp (as the Pallas body does): over 256 tokens cs reaches
// about -480, where exp(cs_i) / exp(cs_j) would be 0/0, and even within 64
// tokens the two factors can leave the fp32 range, so L is never factored.
// cs is accumulated in fp64 (dt * A is formed in fp32): cs_i - cs_j
// subtracts two sums of several hundred, and any fp32 order of the sum
// leaves ~1e-4 of rounding in that difference, which alone exceeds the
// tolerance below at cl = 256. The differences are rounded to fp32 before
// the exp.
//
// Inputs are contiguous: x (B, S, nh, hp), dt (B, S, nh) fp32, A_log (nh,)
// fp32, B/C (B, S, ns); x, B and C are bf16 or fp32. S is a whole number
// of chunks. Outputs are fp32: y (B, nc, cl, nh, hp), states
// (B, nc, nh, hp, ns), exp_cs (B, nc, cl, nh), exp_tot (B, nc, nh). The
// parity tests hold every piece to atol 2e-5 / rtol 2e-4.
//
// One C entry point per dtype and one launch per call, of one of three
// kernels:
//
// * cl == 1 (a decode step, or several one-token chunks), both dtypes:
//   ssd_decode_kernel. Then L = exp(0) = 1 and total = cs, so per (token,
//   head): exp_cs = exp_tot = exp(dt A), y[p] = (C·B) (x[p] dt) and
//   st[p][n] = (x[p] dt) B[n]. One CTA per (token, head); each warp forms
//   C·B itself by a shuffle reduction, so there is no scan, no barrier and
//   no staged tile, and the hp x ns states go out as 16-byte rows. It is
//   bound by the bytes of the states it writes.
//
// * bf16 and cl > 1, hp in {16, 32, 64, 128}, ns a multiple of 8, 16-byte
//   aligned x/B/C (every serving shape): ssd_chunk_mma_kernel, the chunk
//   products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums;
//   the helpers, shared with ssd_bwd.cu, are in mma_sync.cuh).
//   Why that meets the fp32 tolerance:
//     - C·B^T needs no split: a product of two bf16 values is exact in
//       fp32, so one bf16 pass with fp32 sums is the fp32 product up to
//       the order of the sum.
//     - y: dt is folded into the scores, a[i][j] = (C·B^T)[i][j] L[i][j]
//       dt_j in fp32 registers, and y = a x. x is bf16, so exact; a is
//       split into three bf16 pieces, hi = bf16(a), mid = bf16(a - hi),
//       lo = bf16(a - hi - mid) (24 bits of a's significand), and y sums
//       three passes. At cl = 256 one unsplit bf16 pass misses the
//       tolerance many times over and two pieces use much of it; three
//       use a few percent (ssd_chunk_split_ref is this arithmetic on the
//       CPU, and tests/test_torch_ssd.py pins all three).
//     - states: st[p][n] = sum_j w[j][p] B[j][n], w = (x dt_j)
//       exp(total - cs_j), split the same way; B is exact.
//   Layout: a CTA owns HG heads (2, or 1 at hp 128) of one (batch, chunk)
//   and one role, with 4 warps a head. A y role owns 64 rows i and walks
//   the key tiles j <= i; warp w takes rows 16 (w % 4) .. + 16 of head
//   w / 4. Per key tile the warps of a row group form its 16 x 64 block of
//   C·B^T, each a share of the keys, and leave it in shared memory in
//   accumulator order, so it is formed once for all heads of the CTA (C's
//   rows stay in shared memory). Each warp then turns the block into its
//   head's split A operands in registers (the m16n8 accumulator layout of
//   two key blocks is the m16n8k16 A layout, as flash kernels feed P·V)
//   and multiplies with x read by ldmatrix.trans; on the diagonal tile it
//   skips the 16-key blocks above its rows. A state role owns a 64 x 64
//   (p, n) tile and walks every key tile; warp w takes p rows
//   16 (w % 4) .. + 16 of head w / 4. B and x tiles arrive by 16-byte
//   cp.async into a two-stage ring (the next key tile loads during this
//   one's products); outputs are staged in shared memory and written as
//   coalesced 16-byte rows. Roles are ordered heavy first (state tiles,
//   then y tiles from the last row tile down). cs is a warp-level fp64
//   scan per head.
//
// * otherwise (fp32 with cl > 1, or a bf16 shape the mma kernel does not
//   take): ssd_chunk_kernel, the scalar kernel, fp32 FMAs on the CUDA
//   cores: a CTA per (batch · chunk, head, 64-row tile) walks the key
//   tiles for y, and a CTA per 64 x 64 state tile, each with a block-wide
//   fp64 scan. The serving path never runs it (it computes in bf16).
//
// What bounds it on the card: at zamba2-2.7b's prefill (B 4, S 512, cl
// 256, nh 80, hp 64, ns 64) the function moves ~75 MB (x in bf16, y and
// states in fp32; y alone is 56%): ~0.022 ms at 3.35 TB/s. Its ~4.2 GFLOP
// are ~20 GFLOP of bf16 tensor-core work after the splits (C·B^T once a
// head pair, y and the states three passes each): ~0.02 ms at 989 TFLOP/s,
// under the bytes. A decode step is bound by the states it writes (5.2 MB
// at zamba2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int MAX_HP = 128;
constexpr int MAX_NS = 256;
constexpr int MAX_SMEM = 232448;          // a block's shared memory, bytes

// cudaFuncSetAttribute for dynamic shared memory above 48 KB, once per
// kernel instance, device and size (the largest size granted is kept).
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<int> granted[64];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && granted[dev].load() >= int(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < 64) granted[dev].store(int(bytes));
  return err;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// the scalar kernel (fp32 FMAs)
// ---------------------------------------------------------------------------

namespace scalar {

constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TILE = 64;          // rows / keys / state columns per tile
constexpr int LDT = TILE + 4;     // row stride of transposed tiles (16 B)
constexpr float MASKED = -1e9f;   // the Pallas body's mask value

struct Args {
  int S, nh, hp, ns, cl, nc;
  int n_rt;                       // 64-row tiles of a chunk (y tiles)
  int n_pt, n_nt;                 // 64-wide tiles of hp and ns (states)
};

// cs[i] = sum_{k <= i} dt[k * nh] * A (fp64) for i < n, into shared memory,
// by a block-wide scan (warp shuffles, then the warps' totals) in segments
// of THREADS tokens. Ends with a barrier: cs is visible to every thread.
__device__ void chunk_cumsum(const float* dt, int nh, float A, int n,
                             double* cs, double* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int s0 = 0; s0 < n; s0 += THREADS) {
    const int i = s0 + tid;
    double v = i < n ? double(dt[(long long)i * nh] * A) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    double pre = carry, tot = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) pre += wsum[w];
      tot += wsum[w];
    }
    if (i < n) cs[i] = pre + v;
    carry += tot;
    __syncthreads();              // wsum is rewritten by the next segment
  }
}

// ---------------------------------------------------------------------------
// y tile: rows [i0, i0 + 64) of one (batch, chunk, head)
// ---------------------------------------------------------------------------

template <typename TI>
__device__ void y_tile(const TI* __restrict__ x, const float* __restrict__ dtc,
                       const TI* __restrict__ Bm, const TI* __restrict__ Cm,
                       float A, float* __restrict__ y, float* __restrict__ ecs,
                       const Args& a, long long s0, int h, int rt,
                       float* smem) {
  float* Ct = smem;                       // [ns][LDT]: Ct[n][i] = C[i0+i][n]
  float* Bt = Ct + a.ns * LDT;            // [ns][LDT]: Bt[n][j] = B[j0+j][n]
  float* Xs = Bt + a.ns * LDT;            // [64][hp]:  x dt of the key tile
  float* Pt = Xs + TILE * a.hp;           // [64][LDT]: Pt[j][i] = (C B^T ⊙ L)
  double* cs = reinterpret_cast<double*>(Pt + TILE * LDT);   // [cl]
  double* wsum = cs + a.cl;                                  // [8]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = rt * TILE;
  const int rows = min(TILE, a.cl - i0);

  chunk_cumsum(dtc, a.nh, A, i0 + rows, cs, wsum);
  for (int r = tid; r < rows; r += THREADS)
    ecs[(s0 + i0 + r) * a.nh + h] = expf(float(cs[i0 + r]));
  for (int e = tid; e < rows * a.ns; e += THREADS) {
    const int r = e / a.ns, n = e - r * a.ns;
    Ct[n * LDT + r] = ld(Cm + (s0 + i0 + r) * a.ns + n);
  }

  float acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[u][w] = 0.f;

  for (int jt = 0; jt <= rt; ++jt) {
    const int j0 = jt * TILE;
    const int keys = min(TILE, a.cl - j0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < keys * a.ns; e += THREADS) {
      const int r = e / a.ns, n = e - r * a.ns;
      Bt[n * LDT + r] = ld(Bm + (s0 + j0 + r) * a.ns + n);
    }
    for (int e = tid; e < keys * a.hp; e += THREADS) {
      const int r = e / a.hp, p = e - r * a.hp;
      Xs[r * a.hp + p] = ld(x + ((s0 + j0 + r) * a.nh + h) * a.hp + p) *
                         dtc[(long long)(j0 + r) * a.nh];
    }
    __syncthreads();

    // scores: rows ty*4 + u, keys tx*4 + w (entries past rows/keys hold
    // stale shared memory and are never stored)
    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = 0.f;
#pragma unroll 4
    for (int n = 0; n < a.ns; ++n) {
      const float4 c4 = ld4(Ct + n * LDT + ty * 4);
      const float4 b4 = ld4(Bt + n * LDT + tx * 4);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) s[u][w] = fmaf(cv[u], bv[w], s[u][w]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int il = ty * 4 + u, i = i0 + il;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int jl = tx * 4 + w, j = j0 + jl;
        float att = 0.f;
        if (il < rows && jl < keys) {
          const float seg = j <= i ? float(cs[i] - cs[j]) : MASKED;
          att = s[u][w] * expf(seg);
        }
        Pt[jl * LDT + il] = att;
      }
    }
    __syncthreads();

    // y[i][p] += sum_j att[i][j] * xdt[j][p]
#pragma unroll 4
    for (int jj = 0; jj < keys; ++jj) {
      const float4 p4 = ld4(Pt + jj * LDT + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = k * TILE + tx * 4;
        if (col < a.hp) {
          const float4 x4 = ld4(Xs + jj * a.hp + col);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc[u][k * 4 + w] = fmaf(pv[u], xv[w], acc[u][k * 4 + w]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int il = ty * 4 + u;
    if (il >= rows) continue;
    float* yr = y + ((s0 + i0 + il) * a.nh + h) * a.hp;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int col = k * TILE + tx * 4;
      if (col < a.hp)
        *reinterpret_cast<float4*>(yr + col) =
            make_float4(acc[u][k * 4], acc[u][k * 4 + 1], acc[u][k * 4 + 2],
                        acc[u][k * 4 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// state tile: states[p0 .. p0+64)[n0 .. n0+64) of one (batch, chunk, head)
// ---------------------------------------------------------------------------

template <typename TI>
__device__ void state_tile(const TI* __restrict__ x,
                           const float* __restrict__ dtc,
                           const TI* __restrict__ Bm, float A,
                           float* __restrict__ st, float* __restrict__ etot,
                           const Args& a, long long s0, long long bc, int h,
                           int pt, int nt, float* smem) {
  float* Bs = smem;                       // [64][64]: B[j0+j][n0+n]
  float* Xw = Bs + TILE * TILE;           // [64][64]: x dt exp(total-cs_j)
  double* cs = reinterpret_cast<double*>(Xw + TILE * TILE);  // [cl]
  double* wsum = cs + a.cl;                                  // [8]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int p0 = pt * TILE, n0 = nt * TILE;
  const int np = min(TILE, a.hp - p0), nn = min(TILE, a.ns - n0);

  chunk_cumsum(dtc, a.nh, A, a.cl, cs, wsum);
  const double total = cs[a.cl - 1];
  if (pt == 0 && nt == 0 && tid == 0) etot[bc * a.nh + h] = expf(float(total));

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;

  for (int j0 = 0; j0 < a.cl; j0 += TILE) {
    const int keys = min(TILE, a.cl - j0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < keys * TILE; e += THREADS) {
      const int r = e / TILE, c = e - r * TILE;
      const long long row = s0 + j0 + r;
      if (c < nn) Bs[r * TILE + c] = ld(Bm + row * a.ns + n0 + c);
      if (c < np) {
        const float xdt = ld(x + (row * a.nh + h) * a.hp + p0 + c) *
                          dtc[(long long)(j0 + r) * a.nh];
        Xw[r * TILE + c] = xdt * expf(float(total - cs[j0 + r]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < keys; ++jj) {
      const float4 x4 = ld4(Xw + jj * TILE + ty * 4);
      const float4 b4 = ld4(Bs + jj * TILE + tx * 4);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(xv[u], bv[w], acc[u][w]);
    }
  }

  float* sb = st + (bc * a.nh + h) * (long long)a.hp * a.ns;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = ty * 4 + u;
    if (p >= np) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = tx * 4 + w;
      if (n < nn) sb[(long long)(p0 + p) * a.ns + n0 + n] = acc[u][w];
    }
  }
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A_log, const TI* __restrict__ Bm,
                 const TI* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ ecs,
                 float* __restrict__ etot, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y;
  const long long bc = blockIdx.z;                  // b * nc + c
  const long long s0 = bc * a.cl;                   // its first token
  const float A = -expf(A_log[h]);
  const float* dtc = dt + s0 * a.nh + h;
  const int role = blockIdx.x;
  if (role < a.n_rt) {
    y_tile<TI>(x, dtc, Bm, Cm, A, y, ecs, a, s0, h, a.n_rt - 1 - role, smem);
  } else {
    const int k = role - a.n_rt;
    state_tile<TI>(x, dtc, Bm, A, st, etot, a, s0, bc, h, k / a.n_nt,
                   k % a.n_nt, smem);
  }
}

size_t smem_bytes(const Args& a) {
  const size_t y_role = size_t(2) * a.ns * LDT + size_t(TILE) * a.hp +
                        size_t(TILE) * LDT;
  const size_t st_role = size_t(2) * TILE * TILE;
  const size_t cs_tail = size_t(a.cl) + THREADS / 32;   // fp64 cs, wsum
  return sizeof(float) * (y_role > st_role ? y_role : st_role) +
         sizeof(double) * cs_tail;
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16, cl > 1)
// ---------------------------------------------------------------------------

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;          // rows / keys / state rows and columns
constexpr int PAD = 8;            // bf16 row padding: ldmatrix without conflicts

struct Args {
  int nh, ns, cl;
  int nsp;                        // ns rounded up to 16 (C, B tile width)
  int n_kt;                       // 64-key (and 64-row) tiles of a chunk
  int n_nt, n_st;                 // state tiles along ns, and in all
};

// A 64-row tile of 16-byte chunks into shared memory (row stride sstride
// elements) by cp.async: cpr chunks a row, of which the first cvalid are
// read from global rows [0, rows) (row stride gstride elements); the rest
// is zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, int sstride,
                                          const bf16* src, long long gstride,
                                          int rows, int cpr, int cvalid) {
  const int per = blockDim.x / cpr;       // rows a pass
  const int r0 = threadIdx.x / cpr, c = threadIdx.x - r0 * cpr;
  if (r0 >= per) return;
  for (int r = r0; r < TILE; r += per) {
    const bool v = r < rows && c < cvalid;
    cp_async16(dst + r * sstride + c * 8, v ? src + r * gstride + c * 8 : src,
               v);
  }
}

// One warp: cs[j] = sum_{k <= j} dt[k] A (fp64) for j < n, and dts[j] =
// dt[j], into shared memory (dt of token k at dtp[k * nh]). Lanes scan
// consecutive segments, joined by a shuffle scan of their sums.
__device__ void warp_cumsum(const float* __restrict__ dtp, int nh, float A,
                            int n, double* cs, float* dts) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n; j += 32) dts[j] = dtp[(long long)j * nh];
  __syncwarp();
  const int per = (n + 31) >> 5;
  const int j0 = min(lane * per, n), j1 = min(j0 + per, n);
  double sum = 0.0;
  for (int j = j0; j < j1; ++j) sum += double(dts[j] * A);
  double inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  double run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) run = 0.0;
  for (int j = j0; j < j1; ++j) {
    run += double(dts[j] * A);
    cs[j] = run;
  }
  __syncwarp();
}

// A CTA has 4 warps for each of its HG heads: warp w works on head
// w / 4 and on rows (or p rows) 16 (w % 4) .. + 16 of its 64-row tile.
template <int HP, int HG>
struct Layout {
  static constexpr int THREADS = 128 * HG;
  static constexpr int PW = HP < TILE ? HP : TILE;   // p columns, state role
  static constexpr int XS = HP + PAD;                // x row stride, y role
  static constexpr int XW = PW + PAD;                // x row stride, states
  static constexpr int BW = TILE + PAD;              // B row stride, states
  // bf16 elements of one ring stage: y role (B tile, HG x tiles), state
  // role (B column tile, HG x column tiles)
  __host__ __device__ static int y_stage(int nsp) {
    return TILE * (nsp + PAD) + HG * TILE * XS;
  }
  __host__ __device__ static int st_stage() {
    return TILE * BW + HG * TILE * XW;
  }
  // bytes: y role = C rows, two stages and the 64 x 64 block of C·B^T in
  // accumulator order (fp32); state role = two stages; both followed by
  // cs (fp64), dt and exp(total - cs) of the chunk for each head
  __host__ __device__ static size_t ring_bytes(int nsp) {
    const size_t y = 2 * (size_t(TILE) * (nsp + PAD) + 2 * y_stage(nsp)) +
                     4 * TILE * TILE;
    const size_t s = 2 * 2 * size_t(st_stage());
    return y > s ? y : s;
  }
  __host__ __device__ static size_t bytes(int nsp, int cl) {
    return ring_bytes(nsp) + size_t(HG) * cl * (8 + 4 + 4);
  }
};

// y rows [64 rt, 64 rt + 64) of heads h0 .. h0 + HG - 1
template <int HP, int HG>
__device__ void y_tile(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A_log,
                       const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                       float* __restrict__ y, float* __restrict__ ecs,
                       const Args& a, long long bc, int h0, int rt,
                       char* smem) {
  using Lay = Layout<HP, HG>;
  constexpr int XS = Lay::XS, NT = Lay::THREADS;
  constexpr int JN = 8 / HG;              // key n-tiles of C·B^T a warp forms
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, hh = warp >> 2;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, r8 = lane & 7;
  const long long s0 = bc * a.cl;
  const int i0 = rt * TILE, rows = min(TILE, a.cl - i0);
  const int nhg = min(HG, a.nh - h0);
  const bool head = hh < nhg;             // this warp's head exists
  const int CS = a.nsp + PAD;
  const int stage_elems = Lay::y_stage(a.nsp);
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Cs + TILE * CS;
  // Ss[rg][jn][lane]: the accumulator fragment of C·B^T, rows of group rg
  float4* Ss = reinterpret_cast<float4*>(ring + 2 * stage_elems);
  double* csd = reinterpret_cast<double*>(smem + Lay::ring_bytes(a.nsp));
  float* dts = reinterpret_cast<float*>(csd + HG * a.cl);

  auto load_stage = [&](int jt) {
    bf16* Bs = ring + (jt & 1) * stage_elems;
    const int j0 = jt * TILE, kv = min(TILE, a.cl - j0);
    load_tile(Bs, CS, Bm + (s0 + j0) * a.ns, a.ns, kv, a.nsp / 8, a.ns / 8);
#pragma unroll
    for (int k = 0; k < HG; ++k)
      load_tile(Bs + TILE * CS + k * TILE * XS, XS,
                x + ((s0 + j0) * a.nh + h0 + (k < nhg ? k : 0)) * HP,
                (long long)a.nh * HP, k < nhg ? kv : 0, HP / 8, HP / 8);
  };

  load_tile(Cs, CS, Cm + (s0 + i0) * a.ns, a.ns, rows, a.nsp / 8, a.ns / 8);
  load_stage(0);
  cp_async_commit();
  if (rg == 0 && head)
    warp_cumsum(dt + s0 * a.nh + h0 + hh, a.nh, -expf(A_log[h0 + hh]),
                i0 + rows, csd + hh * a.cl, dts + hh * a.cl);
  __syncthreads();
  for (int e = tid; e < rows * HG; e += NT) {
    const int r = e / HG, k = e - r * HG;
    if (k < nhg)
      ecs[(s0 + i0 + r) * a.nh + h0 + k] = expf(float(csd[k * a.cl + i0 + r]));
  }

  // this thread's rows of the tile (rows past the chunk read cs of its
  // last token: their C rows are zero, and they are never stored)
  const int ia = i0 + rg * 16 + g, ib = ia + 8;
  const double* cs = csd + (head ? hh : 0) * a.cl;
  const float* dth = dts + (head ? hh : 0) * a.cl;
  const double csa = cs[min(ia, a.cl - 1)], csb = cs[min(ib, a.cl - 1)];

  float acc[HP / 8][4];
#pragma unroll
  for (int np = 0; np < HP / 8; ++np)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[np][e] = 0.f;

  for (int jt = 0; jt <= rt; ++jt) {
    if (jt < rt) load_stage(jt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Bs = ring + (jt & 1) * stage_elems;
    const bf16* Xs = Bs + TILE * CS + hh * TILE * XS;
    const int j0 = jt * TILE;
    // on the diagonal tile, rows of group rg see keys < 16 rg + 16 only
    const int jn_end = jt == rt ? 2 * rg + 2 : 8;

    // C·B^T, rows of group rg x the key n-tiles [JN hh, JN hh + JN), once
    // for all heads of the CTA
    {
      float s[JN][4];
#pragma unroll
      for (int q = 0; q < JN; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
      if (JN * hh < jn_end) {
        for (int ks = 0; ks < a.nsp / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, Cs + (rg * 16 + (m8 & 1) * 8 + r8) * CS + ks * 16 +
                          (m8 >> 1) * 8);
#pragma unroll
          for (int q = 0; q < JN; q += 2) {
            const int jn = JN * hh + q;
            uint32_t bf[4];
            ldsm_x4(bf, Bs + ((jn + (m8 >> 1)) * 8 + r8) * CS + ks * 16 +
                            (m8 & 1) * 8);
            mma16816(s[q], af, bf[0], bf[1]);
            mma16816(s[q + 1], af, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < JN; ++q)
        Ss[((rg * 8) + JN * hh + q) * 32 + lane] =
            make_float4(s[q][0], s[q][1], s[q][2], s[q][3]);
    }
    __syncthreads();

    if (head) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk >= jn_end) break;
        // a = s L dt_j for keys [16 kk, 16 kk + 16), split into the A
        // operands of three passes (two accumulator tiles = one A tile)
        uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jn = 2 * kk + half;
          const float4 sv = Ss[(rg * 8 + jn) * 32 + lane];
          const int j = j0 + jn * 8 + 2 * t;
          const int jc0 = min(j, a.cl - 1), jc1 = min(j + 1, a.cl - 1);
          const double c0 = cs[jc0], c1 = cs[jc1];
          const float d0 = dth[jc0], d1 = dth[jc1];
          const float v0 = j <= ia ? sv.x * expf(float(csa - c0)) * d0 : 0.f;
          const float v1 =
              j + 1 <= ia ? sv.y * expf(float(csa - c1)) * d1 : 0.f;
          const float v2 = j <= ib ? sv.z * expf(float(csb - c0)) * d0 : 0.f;
          const float v3 =
              j + 1 <= ib ? sv.w * expf(float(csb - c1)) * d1 : 0.f;
          split3(v0, v1, ahi[2 * half], amid[2 * half], alo[2 * half]);
          split3(v2, v3, ahi[2 * half + 1], amid[2 * half + 1],
                 alo[2 * half + 1]);
        }
        uint32_t bx[HP / 8][2];
#pragma unroll
        for (int np = 0; np < HP / 8; np += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Xs + (kk * 16 + (m8 & 1) * 8 + r8) * XS +
                           (np + (m8 >> 1)) * 8);
          bx[np][0] = r[0];
          bx[np][1] = r[1];
          bx[np + 1][0] = r[2];
          bx[np + 1][1] = r[3];
        }
        // pass by pass, so that consecutive products are independent
#pragma unroll
        for (int np = 0; np < HP / 8; ++np)
          mma16816(acc[np], ahi, bx[np][0], bx[np][1]);
#pragma unroll
        for (int np = 0; np < HP / 8; ++np)
          mma16816(acc[np], amid, bx[np][0], bx[np][1]);
#pragma unroll
        for (int np = 0; np < HP / 8; ++np)
          mma16816(acc[np], alo, bx[np][0], bx[np][1]);
      }
    }
    __syncthreads();                      // this stage and Ss are consumed
  }

  // stage the tile's rows (HG heads side by side, as y holds them) in the
  // ring, then write them as 16-byte chunks
  constexpr int YS = HG * HP + 4;
  float* Ys = reinterpret_cast<float*>(ring);
  const int la = rg * 16 + g;
#pragma unroll
  for (int np = 0; np < HP / 8; ++np) {
    const int col = hh * HP + np * 8 + 2 * t;
    *reinterpret_cast<float2*>(Ys + la * YS + col) =
        make_float2(acc[np][0], acc[np][1]);
    *reinterpret_cast<float2*>(Ys + (la + 8) * YS + col) =
        make_float2(acc[np][2], acc[np][3]);
  }
  __syncthreads();
  constexpr int CPR = HG * HP / 4;
  const int valid = nhg * HP / 4;
  for (int e = tid; e < TILE * CPR; e += NT) {
    const int r = e / CPR, c = e - r * CPR;
    if (r < rows && c < valid)
      *reinterpret_cast<float4*>(y + ((s0 + i0 + r) * a.nh + h0) * HP +
                                 c * 4) =
          *reinterpret_cast<const float4*>(Ys + r * YS + c * 4);
  }
}

// states[p0 .. p0 + 64)[n0 .. n0 + 64) of heads h0 .. h0 + HG - 1
template <int HP, int HG>
__device__ void state_tile(const bf16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ A_log,
                           const bf16* __restrict__ Bm,
                           float* __restrict__ st, float* __restrict__ etot,
                           const Args& a, long long bc, int h0, int pt, int nt,
                           char* smem) {
  using Lay = Layout<HP, HG>;
  constexpr int PW = Lay::PW, XW = Lay::XW, BW = Lay::BW, NT = Lay::THREADS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pg = warp & 3, hh = warp >> 2;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, r8 = lane & 7;
  const long long s0 = bc * a.cl;
  const int p0 = pt * TILE, n0 = nt * TILE;
  const int nhg = min(HG, a.nh - h0);
  // this warp's head exists and its 16 p rows lie inside the tile
  const bool active = hh < nhg && pg * 16 < PW;
  const int stage_elems = Lay::st_stage();
  bf16* ring = reinterpret_cast<bf16*>(smem);
  double* csd = reinterpret_cast<double*>(smem + Lay::ring_bytes(a.nsp));
  float* dts = reinterpret_cast<float*>(csd + HG * a.cl);
  float* es = dts + HG * a.cl;

  auto load_stage = [&](int jt) {
    bf16* Bs = ring + (jt & 1) * stage_elems;
    const int j0 = jt * TILE, kv = min(TILE, a.cl - j0);
    load_tile(Bs, BW, Bm + (s0 + j0) * a.ns + n0, a.ns, kv, TILE / 8,
              min(TILE, a.ns - n0) / 8);
#pragma unroll
    for (int k = 0; k < HG; ++k)
      load_tile(Bs + TILE * BW + k * TILE * XW, XW,
                x + ((s0 + j0) * a.nh + h0 + (k < nhg ? k : 0)) * HP + p0,
                (long long)a.nh * HP, k < nhg ? kv : 0, PW / 8, PW / 8);
  };

  load_stage(0);
  cp_async_commit();
  if (pg == 0 && hh < nhg) {
    double* cs = csd + hh * a.cl;
    warp_cumsum(dt + s0 * a.nh + h0 + hh, a.nh, -expf(A_log[h0 + hh]),
                a.cl, cs, dts + hh * a.cl);
    const double total = cs[a.cl - 1];
    for (int j = lane; j < a.cl; j += 32)
      es[hh * a.cl + j] = expf(float(total - cs[j]));
    if (pt == 0 && nt == 0 && lane == 0)
      etot[bc * a.nh + h0 + hh] = expf(float(total));
  }
  __syncthreads();

  const float* dth = dts + (hh < nhg ? hh : 0) * a.cl;
  const float* eh = es + (hh < nhg ? hh : 0) * a.cl;
  float acc[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  for (int jt = 0; jt < a.n_kt; ++jt) {
    if (jt + 1 < a.n_kt) load_stage(jt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Bs = ring + (jt & 1) * stage_elems;
    const bf16* Xs = Bs + TILE * BW + hh * TILE * XW;
    const int j0 = jt * TILE;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bfr[8][2];
#pragma unroll
        for (int nn = 0; nn < 8; nn += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Bs + (ks * 16 + (m8 & 1) * 8 + r8) * BW +
                           (nn + (m8 >> 1)) * 8);
          bfr[nn][0] = r[0];
          bfr[nn][1] = r[1];
          bfr[nn + 1][0] = r[2];
          bfr[nn + 1][1] = r[3];
        }
        // keys of this thread's A elements: j, j + 1 and j + 8, j + 9
        const int j = j0 + ks * 16 + 2 * t;
        int jc[4] = {j, j + 1, j + 8, j + 9};
#pragma unroll
        for (int q = 0; q < 4; ++q) jc[q] = min(jc[q], a.cl - 1);
        // A[p][j] = x[j][p]: row p = 16 pg + g (+ 8), keys as above
        uint32_t xa[4];
        ldsm_x4_t(xa, Xs + (ks * 16 + (m8 >> 1) * 8 + r8) * XW + pg * 16 +
                          (m8 & 1) * 8);
        uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k0 = (q >> 1) * 2;    // registers 0, 1: keys j, j + 1
          split3((lo_f(xa[q]) * dth[jc[k0]]) * eh[jc[k0]],
                 (hi_f(xa[q]) * dth[jc[k0 + 1]]) * eh[jc[k0 + 1]], ahi[q],
                 amid[q], alo[q]);
        }
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          mma16816(acc[nn], ahi, bfr[nn][0], bfr[nn][1]);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          mma16816(acc[nn], amid, bfr[nn][0], bfr[nn][1]);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          mma16816(acc[nn], alo, bfr[nn][0], bfr[nn][1]);
      }
    }
    __syncthreads();                      // this stage is consumed
  }

  // stage [head][p][n] in the ring, then write rows of 16-byte chunks
  constexpr int SS = TILE + 4;
  float* Ss = reinterpret_cast<float*>(ring);
  if (active) {
    float* base = Ss + (hh * PW + pg * 16 + g) * SS + 2 * t;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      *reinterpret_cast<float2*>(base + nn * 8) =
          make_float2(acc[nn][0], acc[nn][1]);
      *reinterpret_cast<float2*>(base + 8 * SS + nn * 8) =
          make_float2(acc[nn][2], acc[nn][3]);
    }
  }
  __syncthreads();
  const int valid = min(TILE, a.ns - n0) / 4;
  for (int e = tid; e < HG * PW * (TILE / 4); e += NT) {
    const int r = e / (TILE / 4), c = e - r * (TILE / 4);
    const int k = r / PW, p = r - k * PW;
    if (k < nhg && c < valid)
      *reinterpret_cast<float4*>(
          st + ((bc * a.nh + h0 + k) * (long long)HP + p0 + p) * a.ns + n0 +
          c * 4) = *reinterpret_cast<const float4*>(Ss + r * SS + c * 4);
  }
}

// grid (head groups, batch * chunks, roles): roles [0, n_st) are state
// tiles, then y row tiles from the last (heaviest) down
template <int HP, int HG>
__global__ void __launch_bounds__(128 * HG)
ssd_chunk_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A_log,
                     const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     float* __restrict__ y, float* __restrict__ st,
                     float* __restrict__ ecs, float* __restrict__ etot,
                     Args a) {
  extern __shared__ __align__(128) char smem[];
  const int h0 = blockIdx.x * HG;
  const long long bc = blockIdx.y;
  const int role = blockIdx.z;
  if (role < a.n_st) {
    const int pt = role / a.n_nt;
    state_tile<HP, HG>(x, dt, A_log, Bm, st, etot, a, bc, h0, pt,
                       role - pt * a.n_nt, smem);
  } else {
    y_tile<HP, HG>(x, dt, A_log, Bm, Cm, y, ecs, a, bc, h0,
                   a.n_kt - 1 - (role - a.n_st), smem);
  }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// the decode kernel (cl == 1, both dtypes)
// ---------------------------------------------------------------------------

namespace decode {

constexpr int THREADS = 128;

// one CTA per (head, token): blockIdx.x the head, blockIdx.y the token
template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_decode_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A_log, const TI* __restrict__ Bm,
                  const TI* __restrict__ Cm, float* __restrict__ y,
                  float* __restrict__ st, float* __restrict__ ecs,
                  float* __restrict__ etot, int nh, int hp, int ns) {
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const long long th = (long long)blockIdx.y * nh + h;   // (token, head)
  const float d = dt[th];
  if (tid == 0) {
    const float e = expf(d * -expf(A_log[h]));   // cs = total = dt A
    ecs[th] = e;
    etot[th] = e;
  }
  const TI* Bt = Bm + (long long)blockIdx.y * ns;
  const TI* Ct = Cm + (long long)blockIdx.y * ns;
  float sc = 0.f;                                 // C·B, in every warp
  for (int n = lane; n < ns; n += 32) sc = fmaf(ld(Ct + n), ld(Bt + n), sc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sc += __shfl_xor_sync(0xffffffffu, sc, off);

  const TI* xr = x + th * hp;
  float* yr = y + th * hp;
  for (int q = tid; q < hp / 4; q += THREADS) {   // hp is a multiple of 4
    const TI* xp = xr + 4 * q;
    *reinterpret_cast<float4*>(yr + 4 * q) =
        make_float4(sc * (ld(xp) * d), sc * (ld(xp + 1) * d),
                    sc * (ld(xp + 2) * d), sc * (ld(xp + 3) * d));
  }

  float* sb = st + th * hp * (long long)ns;
  if (ns % 4 == 0 && ns / 4 <= THREADS) {
    // a thread owns 4 columns n of every (THREADS / (ns / 4))-th row p
    const int cpr = ns / 4, rpp = THREADS / cpr;
    const int r0 = tid / cpr, c = tid - r0 * cpr;
    if (r0 >= rpp) return;
    const float b0 = ld(Bt + 4 * c), b1 = ld(Bt + 4 * c + 1),
                b2 = ld(Bt + 4 * c + 2), b3 = ld(Bt + 4 * c + 3);
    for (int p = r0; p < hp; p += rpp) {
      const float xd = ld(xr + p) * d;
      *reinterpret_cast<float4*>(sb + (long long)p * ns + 4 * c) =
          make_float4(xd * b0, xd * b1, xd * b2, xd * b3);
    }
  } else {
    for (int p = 0; p < hp; ++p) {
      const float xd = ld(xr + p) * d;
      for (int n = tid; n < ns; n += THREADS)
        sb[(long long)p * ns + n] = xd * ld(Bt + n);
    }
  }
}

}  // namespace decode

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

enum Path { SCALAR = 0, MMA = 1, DECODE = 2 };

// the kernel instance, grid and shared memory of one call
struct Launch {
  Path path;
  const void* kernel;
  dim3 grid;
  int threads, heads_per_cta;
  size_t smem;
  cudaError_t (*allow)(size_t);
  mma::Args ma;
  scalar::Args sa;
};

// heads a CTA: 2 (sharing C·B^T), 1 at hp 128 (the accumulators of two
// would not fit the registers)
template <int HP>
bool plan_mma(Launch& L, int B, int S, int nh, int ns, int cl) {
  constexpr int HG = HP >= 128 ? 1 : 2;
  mma::Args& a = L.ma;
  a.nh = nh; a.ns = ns; a.cl = cl;
  a.nsp = (ns + 15) / 16 * 16;
  a.n_kt = (cl + mma::TILE - 1) / mma::TILE;
  a.n_nt = (ns + mma::TILE - 1) / mma::TILE;
  a.n_st = (HP + mma::TILE - 1) / mma::TILE * a.n_nt;
  L.smem = mma::Layout<HP, HG>::bytes(a.nsp, cl);
  if (L.smem > size_t(MAX_SMEM)) return false;
  L.path = MMA;
  L.kernel = reinterpret_cast<const void*>(mma::ssd_chunk_mma_kernel<HP, HG>);
  L.allow = allow_smem<mma::ssd_chunk_mma_kernel<HP, HG>>;
  L.grid = dim3((nh + HG - 1) / HG, B * (S / cl), a.n_st + a.n_kt);
  L.threads = mma::Layout<HP, HG>::THREADS;
  L.heads_per_cta = HG;
  return true;
}

// Which kernel a call runs (aligned: x, B and C start on 16 bytes)
template <typename TI>
int plan(Launch& L, int B, int S, int nh, int hp, int ns, int cl,
         bool aligned) {
  if (B <= 0 || S <= 0 || nh <= 0 || cl <= 0 || S % cl || hp <= 0 ||
      hp > MAX_HP || hp % 4 || ns <= 0 || ns > MAX_NS || nh > 65535 ||
      (long long)B * (S / cl) > 65535)
    return int(cudaErrorInvalidValue);
  if (cl == 1) {
    L.path = DECODE;
    L.kernel = reinterpret_cast<const void*>(decode::ssd_decode_kernel<TI>);
    L.allow = allow_smem<decode::ssd_decode_kernel<TI>>;
    L.grid = dim3(nh, B * S, 1);
    L.threads = decode::THREADS;
    L.heads_per_cta = 1;
    L.smem = 0;
    return 0;
  }
  if (std::is_same<TI, __nv_bfloat16>::value && aligned && ns % 8 == 0) {
    const bool ok = hp == 16   ? plan_mma<16>(L, B, S, nh, ns, cl)
                    : hp == 32 ? plan_mma<32>(L, B, S, nh, ns, cl)
                    : hp == 64 ? plan_mma<64>(L, B, S, nh, ns, cl)
                    : hp == 128 ? plan_mma<128>(L, B, S, nh, ns, cl)
                                : false;
    if (ok) return 0;
  }
  scalar::Args& a = L.sa;
  a.S = S; a.nh = nh; a.hp = hp; a.ns = ns; a.cl = cl; a.nc = S / cl;
  a.n_rt = (cl + scalar::TILE - 1) / scalar::TILE;
  a.n_pt = (hp + scalar::TILE - 1) / scalar::TILE;
  a.n_nt = (ns + scalar::TILE - 1) / scalar::TILE;
  L.smem = scalar::smem_bytes(a);
  if (L.smem > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  L.path = SCALAR;
  L.kernel = reinterpret_cast<const void*>(scalar::ssd_chunk_kernel<TI>);
  L.allow = allow_smem<scalar::ssd_chunk_kernel<TI>>;
  L.grid = dim3(a.n_rt + a.n_pt * a.n_nt, nh, B * a.nc);
  L.threads = scalar::THREADS;
  L.heads_per_cta = 1;
  return 0;
}

template <typename TI>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, void* y, void* st, void* ecs, void* etot, int B,
           int S, int nh, int hp, int ns, int cl, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
        reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  Launch L;
  int err = plan<TI>(L, B, S, nh, hp, ns, cl, aligned);
  if (err) return err;
  cudaError_t e = L.allow(L.smem);
  if (e != cudaSuccess) return int(e);
  const TI* xt = static_cast<const TI*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const TI* Bt = static_cast<const TI*>(Bm);
  const TI* Ct = static_cast<const TI*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  float* ef = static_cast<float*>(ecs);
  float* tf = static_cast<float*>(etot);
  if (L.path == DECODE) {
    decode::ssd_decode_kernel<TI><<<L.grid, L.threads, 0, stream>>>(
        xt, dtf, al, Bt, Ct, yf, sf, ef, tf, nh, hp, ns);
  } else if (L.path == SCALAR) {
    scalar::ssd_chunk_kernel<TI><<<L.grid, L.threads, L.smem, stream>>>(
        xt, dtf, al, Bt, Ct, yf, sf, ef, tf, L.sa);
  } else {
    void* args[] = {&x, &dt, &A_log, &Bm, &Cm, &y, &st, &ecs, &etot, &L.ma};
    e = cudaLaunchKernel(L.kernel, L.grid, dim3(L.threads), args, L.smem,
                         stream);
    if (e != cudaSuccess) return int(e);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int ssd_chunk_bf16(const void* x, const void* dt, const void* A_log,
                   const void* Bm, const void* Cm, void* y, void* st,
                   void* ecs, void* etot, int B, int S, int nh, int hp,
                   int ns, int cl, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, y, st, ecs, etot, B, S,
                               nh, hp, ns, cl,
                               static_cast<cudaStream_t>(stream));
}

int ssd_chunk_f32(const void* x, const void* dt, const void* A_log,
                  const void* Bm, const void* Cm, void* y, void* st,
                  void* ecs, void* etot, int B, int S, int nh, int hp, int ns,
                  int cl, void* stream) {
  return launch<float>(x, dt, A_log, Bm, Cm, y, st, ecs, etot, B, S, nh, hp,
                       ns, cl, static_cast<cudaStream_t>(stream));
}

// The plan of a call at these shapes (x, B and C 16-byte aligned), into
// out[9]: path (0 scalar, 1 tensor cores, 2 decode), CTAs, threads a CTA,
// heads a CTA, dynamic shared memory bytes, CTAs resident an SM,
// registers a thread, local memory bytes a thread (spills), SMs.
int ssd_chunk_plan(int B, int S, int nh, int hp, int ns, int cl, int bf16,
                   int* out) {
  Launch L;
  int err = bf16 ? plan<__nv_bfloat16>(L, B, S, nh, hp, ns, cl, true)
                 : plan<float>(L, B, S, nh, hp, ns, cl, true);
  if (err) return err;
  cudaError_t e = L.allow(L.smem);
  cudaFuncAttributes fa;
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, L.kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, L.kernel,
                                                      L.threads, L.smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  out[0] = int(L.path);
  out[1] = int(L.grid.x * L.grid.y * L.grid.z);
  out[2] = L.threads;
  out[3] = L.heads_per_cta;
  out[4] = int(L.smem);
  out[5] = per_sm;
  out[6] = fa.numRegs;
  out[7] = int(fa.localSizeBytes);
  out[8] = sms;
  return 0;
}

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
