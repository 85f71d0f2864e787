// Gradient of the Mamba2 SSD intra-chunk step for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: the gradient that jax.grad takes through the jnp ssd_chunked
//           of src/repro/models/mamba.py:76 (one jax.checkpoint a chunk);
//           the JAX package has no Pallas backward. Its forward is
//           csrc/ssd_chunk.cu (the Pallas ssd_chunk_call).
//
// Per (batch, chunk of cl tokens, head h) the forward computed, with
// A = -exp(A_log[h]), cs = cumsum(dt A) in fp64, xdt_j = x_j dt_j,
// s_ij = C_i·B_j (shared by the heads), L_ij = exp(cs_i - cs_j) for j <= i
// (0 above), P = s ⊙ L and w_j = exp(tot - cs_j), tot = cs[cl - 1]:
//   y_i = Σ_j P_ij xdt_j,  st = Σ_j w_j xdt_j ⊗ B_j,  exp(cs),  exp(tot).
// Given the fp32 cotangents dy, dst, decs, detot this source computes
//   dxdt_j = Σ_{i>=j} P_ij dy_i + w_j (dst B_j)
//   g_ij   = dy_i · xdt_j,   ds_ij = Σ_h L_ij g_ij
//   dC_i   = Σ_j ds_ij B_j,  dB_j = Σ_i ds_ij C_i + Σ_h w_j dstᵀ xdt_j
//   dcs_i  = Σ_j r_ij - Σ_k r_ki - u_i + decs_i exp(cs_i)
//            (+ Σ_j u_j + detot exp(tot) at the last token),
//            r = P ⊙ g,  u_j = w_j xdt_j · (dst B_j)
//   d(dt A)_k = Σ_{i>=k} dcs_i (fp64, as cs is summed)
//   dx_j = dxdt_j dt_j,  ddt_j = dxdt_j · x_j + d(dt A)_j A,
//   dA_log = A Σ_{b, chunk, j} d(dt A)_j dt_j.
// As in the forward, the upper triangle is set to exactly 0 before any
// exp or product, so no inf or NaN can enter a sum (inf · 0 is the NaN
// the JAX comment at mamba.py:118 warns of), and cs_i - cs_j is an fp64
// difference rounded to fp32 before the exp.
//
// Inputs are contiguous: x (B, S, nh, hp), B/C (B, S, ns) in bf16 or fp32,
// dt (B, S, nh) and A_log (nh,) fp32; dy (B, nc, cl, nh, hp), dst (B, nc,
// nh, hp, ns), decs (B, nc, cl, nh), detot (B, nc, nh) fp32. Outputs: dx,
// dB, dC in the inputs' dtype, ddt and dA_log fp32. hp and ns are
// multiples of 4, hp <= 64, ns <= 128, cl <= 256 (every training shape).
// The plain twin is ref.ssd_chunk_bwd_ref.
//
// Deterministic, with no atomics: every sum over heads, tiles or chunks
// runs in a fixed order, through fp32/fp64 partials in a scratch buffer
// the wrapper allocates (ssd_bwd_workspace bytes). One C entry point per
// dtype launches five kernels on the stream, 256 threads a CTA, each
// thread 4 x 4 outputs of a 64 x 64 tile, fp32 FMAs on the CUDA cores:
//
//  1. ssd_bwd_head_kernel, a CTA per (64-key tile jt, head, batch ·
//     chunk): the fp64 scan of cs (written to scratch by jt = 0), dst B_j,
//     u_j, then for each row tile it >= jt the tiles s, g, P and r, and
//     dxdt_j += Pᵀ dy_i. Writes dx, and to scratch the row sums of r (one
//     partial a (jt, row)), the column sums of r, u and dxdt · x.
//  2. ssd_bwd_ds_kernel, a CTA per (row tile, key tile) pair on or below
//     the diagonal and (batch · chunk): ds = Σ_h L ⊙ g over the heads in
//     order, into scratch (0 above the diagonal).
//  3. ssd_bwd_dbc_kernel, a CTA per (role, batch · chunk): dC for a row
//     tile (Σ over key tiles of ds B), or dB for a key tile (Σ over row
//     tiles of dsᵀ C, then the heads' w xdt dstᵀ in order).
//  4. ssd_bwd_finish_kernel, a CTA per (head, batch · chunk), one thread
//     a token: dcs in fp64, its reverse cumsum by a block scan, ddt, and
//     the chunk's Σ d(dt A) dt for dA_log.
//  5. ssd_bwd_dalog_kernel, a CTA a head: dA_log = A Σ over the chunks,
//     in order.
//
// What bounds it: at zamba2-2.7b's training call (x (1, 4096, 80, 64),
// ns 64, cl 256, bf16) the function moves ~195 MB (the fp32 dy alone is
// 84 MB, x and dx 42 MB each): ~0.058 ms at 3.35 TB/s. Its ~16.6 GFLOP
// (g and Pᵀdy on the lower triangle a head, dst B and the states' dB
// term, s, dC, dB once a chunk) take ~0.034 ms at the 495 TFLOP/s TF32
// tensor-core rate: bytes bound it (chip_smoke.ssd_bwd_work counts both).
// This first kernel runs its products as fp32 FMAs (67 TFLOP/s peak),
// recomputes s for every head and g twice (kernels 1 and 2), and keeps
// one 256-thread CTA's tiles in shared memory, so it is far from that
// bound; the tensor cores (the forward's mma.sync on three-piece bf16
// splits, or wgmma) and fewer passes over dy are a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;          // rows / keys a tile
constexpr int LDT = TILE + 4;     // row stride of 64-wide tiles (16 B)
constexpr int MAX_HP = 64;
constexpr int MAX_NS = 128;
constexpr int MAX_CL = THREADS;   // the finish kernel: one thread a token
constexpr int MAX_SMEM = 232448;  // a block's shared memory, bytes

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
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Args {
  int nh, hp, ns, cl, n_kt;
  int ldh, ldn;                   // hp + 4, ns + 4: row strides (16 B)
  long long BC;                   // batch · chunks
};

// the scratch buffer, carved in this order (fp64 first)
struct Scratch {
  double* cs;                     // (BC, nh, cl)  cs of each head
  double* dap;                    // (BC, nh)      Σ_k d(dt A)_k dt_k
  float* rowp;                    // (BC, n_kt, nh, cl) row sums of r, by jt
  float* cols;                    // (BC, nh, cl)  column sums of r
  float* uu;                      // (BC, nh, cl)  u
  float* dot;                     // (BC, nh, cl)  dxdt · x
  float* ds;                      // (BC, cl, cl)  ds (0 above the diagonal)
};

long long scratch_bytes(long long BC, int nh, int cl) {
  const long long n_kt = (cl + TILE - 1) / TILE;
  return 8 * (BC * nh * cl + BC * nh) +
         4 * (BC * n_kt * nh * cl + 3 * BC * nh * cl + BC * cl * cl);
}

Scratch carve(void* base, long long BC, int nh, int cl) {
  const long long n_kt = (cl + TILE - 1) / TILE;
  Scratch s;
  s.cs = static_cast<double*>(base);
  s.dap = s.cs + BC * nh * cl;
  s.rowp = reinterpret_cast<float*>(s.dap + BC * nh);
  s.cols = s.rowp + BC * n_kt * nh * cl;
  s.uu = s.cols + BC * nh * cl;
  s.dot = s.uu + BC * nh * cl;
  s.ds = s.dot + BC * nh * cl;
  return s;
}

// cs[i] = sum_{k <= i} dt[k * nh] * A (fp64) for i < n, into shared memory,
// by a block-wide scan (csrc/ssd_chunk.cu's scalar kernel's chunk_cumsum).
// Ends with a barrier.
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
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pre += wsum[w];
      tot += wsum[w];
    }
    if (i < n) cs[i] = pre + v;
    carry += tot;
    __syncthreads();              // wsum is rewritten by the next segment
  }
}

// the sum over the 16 threads of a tile row (tx = 0..15, lanes of one
// half-warp); every thread of the warp must call it
__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// the sum of v over the block, the same bits in every thread (a fixed
// order); every thread must call it; red holds WARPS doubles
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();                // red may still be read by a last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

// acc[u][4 g + w] += Σ_{k < K} a[k lda + 4 ty + u] ·
//                               b[k ldb + 64 g + 4 tx + w]
// for the column groups g < NG whose columns lie below ncols: the 64 rows
// of the output tile against NG x 64 columns, both operands in shared
// memory with k the slow index
template <int NG>
__device__ __forceinline__ void mm(float (&acc)[4][4 * NG],
                                   const float* __restrict__ a, int lda,
                                   const float* __restrict__ b, int ldb,
                                   int K, int ncols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  bool on[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) on[g] = g * TILE + tx * 4 < ncols;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a4 = ld4(a + (long long)k * lda + ty * 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (!on[g]) continue;
      const float4 b4 = ld4(b + (long long)k * ldb + g * TILE + tx * 4);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          acc[u][g * 4 + w] = fmaf(av[u], bv[w], acc[u][g * 4 + w]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[4][N]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < N; ++w) acc[u][w] = 0.f;
}

// ---------------------------------------------------------------------------
// 1. per head: dx, and the row / column sums of r, u and dxdt · x
// ---------------------------------------------------------------------------

// doubles of the head kernel's cs and wsum, even: the floats after them
// start on 16 bytes
__host__ __device__ int cs_doubles(int cl) { return (cl + WARPS + 1) & ~1; }

size_t head_smem(const Args& a) {
  return sizeof(double) * cs_doubles(a.cl) +
         sizeof(float) * (size_t(2) * a.ns * LDT + size_t(2) * a.hp * LDT +
                          size_t(TILE) * a.ldh + size_t(TILE) * LDT +
                          16 * TILE + 4 * TILE);
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_head_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A_log, const TI* __restrict__ Bm,
            const TI* __restrict__ Cm, const float* __restrict__ dy,
            const float* __restrict__ dst, TI* __restrict__ dx, Scratch sc,
            Args a) {
  extern __shared__ __align__(16) float smem[];
  const int jt = blockIdx.x, h = blockIdx.y;
  const long long bc = blockIdx.z, s0 = bc * a.cl;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float A = -expf(A_log[h]);
  const float* dtc = dt + s0 * a.nh + h;

  double* cs = reinterpret_cast<double*>(smem);            // [cl]
  double* wsum = cs + a.cl;                                 // [WARPS]
  float* Bt = reinterpret_cast<float*>(cs + cs_doubles(a.cl));
  float* Xt = Bt + a.ns * LDT;        // [hp][LDT]: xdt of the key tile
  float* Ct = Xt + a.hp * LDT;        // [ns][LDT]: C of a row tile; first
                                      // dst as Dt[n][p]
  float* DYt = Ct + a.ns * LDT;       // [hp][LDT]: dy of a row tile
  float* DYs = DYt + a.hp * LDT;      // [64][ldh]: the same, row-major
  float* Ps = DYs + TILE * a.ldh;     // [64][LDT]: P[i][j]
  float* red = Ps + TILE * LDT;       // [16][64]: column partials of r
  float* wj = red + 16 * TILE;        // [64] w_j
  float* dtj = wj + TILE;             // [64] dt_j
  float* uS = dtj + TILE;             // [64] u_j
  float* dotS = uS + TILE;            // [64] dxdt_j · x_j

  const int j0 = jt * TILE, keys = min(TILE, a.cl - j0);
  chunk_cumsum(dtc, a.nh, A, a.cl, cs, wsum);
  const double tot = cs[a.cl - 1];
  const long long hrow = (bc * a.nh + h) * (long long)a.cl;
  if (jt == 0)
    for (int i = tid; i < a.cl; i += THREADS) sc.cs[hrow + i] = cs[i];
  if (tid < keys) {
    dtj[tid] = dtc[(long long)(j0 + tid) * a.nh];
    wj[tid] = expf(float(tot - cs[j0 + tid]));
  }
  for (int e = tid; e < keys * a.ns; e += THREADS) {
    const int r = e / a.ns, n = e - r * a.ns;
    Bt[n * LDT + r] = ld(Bm + (s0 + j0 + r) * a.ns + n);
  }
  for (int e = tid; e < keys * a.hp; e += THREADS) {
    const int r = e / a.hp, p = e - r * a.hp;
    Xt[p * LDT + r] = ld(x + ((s0 + j0 + r) * a.nh + h) * a.hp + p) *
                      dtc[(long long)(j0 + r) * a.nh];
  }
  const float* dsth = dst + (bc * a.nh + h) * (long long)a.hp * a.ns;
  for (int e = tid; e < a.hp * a.ns; e += THREADS) {
    const int p = e / a.ns, n = e - p * a.ns;
    Ct[n * LDT + p] = dsth[e];
  }
  __syncthreads();

  // dst B_j (rows j, columns p), u_j, and dxdt = w_j dst B_j to start
  float D[4][4];
  zero(D);
  mm<1>(D, Bt, LDT, Ct, LDT, a.ns, a.hp);
  const bool pcol = tx * 4 < a.hp;
  float u_row[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int jl = ty * 4 + u;
    float part = 0.f;
    if (pcol)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        part = fmaf(D[u][w], Xt[(tx * 4 + w) * LDT + jl], part);
    const float wv = wj[jl];      // stale past keys: that row is not stored
    u_row[u] = wv * row_sum16(part);
#pragma unroll
    for (int w = 0; w < 4; ++w) D[u][w] *= wv;
  }

  float colp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = jt; it < a.n_kt; ++it) {
    const int i0 = it * TILE, rows = min(TILE, a.cl - i0);
    __syncthreads();              // Ct (Dt), DYt, DYs, Ps are consumed
    for (int e = tid; e < rows * a.ns; e += THREADS) {
      const int r = e / a.ns, n = e - r * a.ns;
      Ct[n * LDT + r] = ld(Cm + (s0 + i0 + r) * a.ns + n);
    }
    for (int e = tid; e < rows * a.hp; e += THREADS) {
      const int r = e / a.hp, p = e - r * a.hp;
      const float v = dy[((s0 + i0 + r) * a.nh + h) * a.hp + p];
      DYt[p * LDT + r] = v;
      DYs[r * a.ldh + p] = v;
    }
    __syncthreads();

    float s[4][4], g[4][4];
    zero(s);
    zero(g);
    mm<1>(s, Ct, LDT, Bt, LDT, a.ns, TILE);     // s_ij = C_i · B_j
    mm<1>(g, DYt, LDT, Xt, LDT, a.hp, TILE);    // g_ij = dy_i · xdt_j
    float rsum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int il = ty * 4 + u, i = i0 + il;
      float rs = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int jl = tx * 4 + w, j = j0 + jl;
        float pv = 0.f, rv = 0.f;
        if (il < rows && jl < keys && j <= i) {
          pv = s[u][w] * expf(float(cs[i] - cs[j]));
          rv = pv * g[u][w];
        }
        Ps[il * LDT + jl] = pv;
        rs += rv;
        colp[w] += rv;
      }
      rsum[u] = row_sum16(rs);
    }
    if (tx == 0) {
      float* rp = sc.rowp + ((bc * a.n_kt + jt) * a.nh + h) * (long long)a.cl;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ty * 4 + u < rows) rp[i0 + ty * 4 + u] = rsum[u];
    }
    __syncthreads();              // Ps is complete
    mm<1>(D, Ps, LDT, DYs, a.ldh, rows, a.hp);  // dxdt_j += Σ_i P_ij dy_i
  }

  // dx = dxdt dt, dxdt · x, and the column sums of r in a fixed order
#pragma unroll
  for (int w = 0; w < 4; ++w) red[ty * TILE + tx * 4 + w] = colp[w];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int jl = ty * 4 + u;
    float part = 0.f;
    if (jl < keys && pcol) {
      const long long row = ((s0 + j0 + jl) * a.nh + h) * a.hp + tx * 4;
      const float d = dtj[jl];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        part = fmaf(D[u][w], ld(x + row + w), part);
        st(dx + row + w, D[u][w] * d);
      }
    }
    const float dot = row_sum16(part);
    if (tx == 0) {
      uS[jl] = u_row[u];
      dotS[jl] = dot;
    }
  }
  __syncthreads();
  if (tid < keys) {
    float c = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) c += red[t * TILE + tid];
    sc.cols[hrow + j0 + tid] = c;
    sc.uu[hrow + j0 + tid] = uS[tid];
    sc.dot[hrow + j0 + tid] = dotS[tid];
  }
}

// ---------------------------------------------------------------------------
// 2. ds = Σ_h L ⊙ g for one (row tile, key tile) pair
// ---------------------------------------------------------------------------

size_t ds_smem(const Args& a) {
  return sizeof(double) * 2 * TILE + sizeof(float) * size_t(2) * a.hp * LDT;
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_ds_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ dy, Scratch sc, Args a) {
  extern __shared__ __align__(16) float smem[];
  int q = blockIdx.x, it = 0;     // the pair: jt <= it
  while (q > it) {
    q -= it + 1;
    ++it;
  }
  const int jt = q;
  const long long bc = blockIdx.y, s0 = bc * a.cl;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  double* csi = reinterpret_cast<double*>(smem);           // [64]
  double* csj = csi + TILE;                                // [64]
  float* DYt = reinterpret_cast<float*>(csj + TILE);       // [hp][LDT]
  float* Xt = DYt + a.hp * LDT;                            // [hp][LDT]
  const int i0 = it * TILE, rows = min(TILE, a.cl - i0);
  const int j0 = jt * TILE, keys = min(TILE, a.cl - j0);

  float acc[4][4];
  zero(acc);
  for (int h = 0; h < a.nh; ++h) {
    __syncthreads();              // the previous head's tiles are consumed
    const long long hrow = (bc * a.nh + h) * (long long)a.cl;
    if (tid < rows) csi[tid] = sc.cs[hrow + i0 + tid];
    if (tid >= TILE && tid - TILE < keys)
      csj[tid - TILE] = sc.cs[hrow + j0 + tid - TILE];
    for (int e = tid; e < rows * a.hp; e += THREADS) {
      const int r = e / a.hp, p = e - r * a.hp;
      DYt[p * LDT + r] = dy[((s0 + i0 + r) * a.nh + h) * a.hp + p];
    }
    for (int e = tid; e < keys * a.hp; e += THREADS) {
      const int r = e / a.hp, p = e - r * a.hp;
      const long long tok = s0 + j0 + r;
      Xt[p * LDT + r] =
          ld(x + (tok * a.nh + h) * a.hp + p) * dt[tok * a.nh + h];
    }
    __syncthreads();
    float g[4][4];
    zero(g);
    mm<1>(g, DYt, LDT, Xt, LDT, a.hp, TILE);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int il = ty * 4 + u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int jl = tx * 4 + w;
        if (il < rows && jl < keys && j0 + jl <= i0 + il)
          acc[u][w] = fmaf(expf(float(csi[il] - csj[jl])), g[u][w],
                           acc[u][w]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int il = ty * 4 + u;
    if (il >= rows) continue;
    float* dsr = sc.ds + (bc * a.cl + i0 + il) * (long long)a.cl + j0;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (tx * 4 + w < keys) dsr[tx * 4 + w] = acc[u][w];
  }
}

// ---------------------------------------------------------------------------
// 3. dC for a row tile, or dB for a key tile
// ---------------------------------------------------------------------------

size_t dbc_smem(const Args& a) {
  return sizeof(float) * (size_t(TILE) * LDT + size_t(TILE) * a.ldn +
                          size_t(a.hp) * LDT + size_t(a.hp) * a.ldn);
}

template <typename TI>
__device__ void store_rows(TI* out, const float (&acc)[4][8], long long row0,
                           int rows, int ns) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty * 4 + u;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = g * TILE + tx * 4 + w;
        if (n < ns) st(out + (row0 + r) * ns + n, acc[u][g * 4 + w]);
      }
  }
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
           const TI* __restrict__ Bm, const TI* __restrict__ Cm,
           const float* __restrict__ dst, TI* __restrict__ dB,
           TI* __restrict__ dC, Scratch sc, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int role = blockIdx.x;
  const long long bc = blockIdx.y, s0 = bc * a.cl;
  const int tid = threadIdx.x;
  float* Ds = smem;                       // [64][LDT]: a ds tile
  float* Ms = Ds + TILE * LDT;            // [64][ldn]: B or C rows
  float* Wt = Ms + TILE * a.ldn;          // [hp][LDT]: w_j xdt_j (dB)
  float* Dst = Wt + a.hp * LDT;           // [hp][ldn]: dst of a head (dB)
  const float* dsc = sc.ds + bc * a.cl * (long long)a.cl;
  float acc[4][8];
  zero(acc);

  if (role < a.n_kt) {                    // dC_i = Σ_j ds_ij B_j
    const int i0 = role * TILE, rows = min(TILE, a.cl - i0);
    for (int jt = 0; jt <= role; ++jt) {
      const int j0 = jt * TILE, keys = min(TILE, a.cl - j0);
      __syncthreads();
      for (int e = tid; e < rows * keys; e += THREADS) {
        const int r = e / keys, c = e - r * keys;
        Ds[c * LDT + r] = dsc[(long long)(i0 + r) * a.cl + j0 + c];
      }
      for (int e = tid; e < keys * a.ns; e += THREADS) {
        const int r = e / a.ns, n = e - r * a.ns;
        Ms[r * a.ldn + n] = ld(Bm + (s0 + j0 + r) * a.ns + n);
      }
      __syncthreads();
      mm<2>(acc, Ds, LDT, Ms, a.ldn, keys, a.ns);
    }
    store_rows(dC, acc, s0 + i0, rows, a.ns);
    return;
  }

  // dB_j = Σ_i ds_ij C_i + Σ_h w_j (dst_h)ᵀ xdt_j
  const int jt = role - a.n_kt;
  const int j0 = jt * TILE, keys = min(TILE, a.cl - j0);
  for (int it = jt; it < a.n_kt; ++it) {
    const int i0 = it * TILE, rows = min(TILE, a.cl - i0);
    __syncthreads();
    for (int e = tid; e < rows * keys; e += THREADS) {
      const int r = e / keys, c = e - r * keys;
      Ds[r * LDT + c] = dsc[(long long)(i0 + r) * a.cl + j0 + c];
    }
    for (int e = tid; e < rows * a.ns; e += THREADS) {
      const int r = e / a.ns, n = e - r * a.ns;
      Ms[r * a.ldn + n] = ld(Cm + (s0 + i0 + r) * a.ns + n);
    }
    __syncthreads();
    mm<2>(acc, Ds, LDT, Ms, a.ldn, rows, a.ns);
  }
  for (int h = 0; h < a.nh; ++h) {
    __syncthreads();
    const long long hrow = (bc * a.nh + h) * (long long)a.cl;
    const double tot = sc.cs[hrow + a.cl - 1];
    for (int e = tid; e < keys * a.hp; e += THREADS) {
      const int r = e / a.hp, p = e - r * a.hp;
      const long long tok = s0 + j0 + r;
      const float xdt =
          ld(x + (tok * a.nh + h) * a.hp + p) * dt[tok * a.nh + h];
      Wt[p * LDT + r] = expf(float(tot - sc.cs[hrow + j0 + r])) * xdt;
    }
    const float* dh = dst + (bc * a.nh + h) * (long long)a.hp * a.ns;
    for (int e = tid; e < a.hp * a.ns; e += THREADS) {
      const int p = e / a.ns, n = e - p * a.ns;
      Dst[p * a.ldn + n] = dh[e];
    }
    __syncthreads();
    mm<2>(acc, Wt, LDT, Dst, a.ldn, a.hp, a.ns);
  }
  store_rows(dB, acc, s0 + j0, keys, a.ns);
}

// ---------------------------------------------------------------------------
// 4. dcs, its reverse cumsum, ddt and the chunk's part of dA_log
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A_log,
              const float* __restrict__ decs, const float* __restrict__ detot,
              float* __restrict__ ddt, Scratch sc, Args a) {
  __shared__ double red[WARPS];
  const int h = blockIdx.x;
  const long long bc = blockIdx.y, s0 = bc * a.cl;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k = a.cl - 1 - t;             // thread t holds token cl-1-t
  const bool on = t < a.cl;
  const float A = -expf(A_log[h]);
  const long long hrow = (bc * a.nh + h) * (long long)a.cl;
  double c = 0.0, u = 0.0;
  if (on) {
    double rs = 0.0;
    for (int jt = 0; jt <= k / TILE; ++jt)
      rs += double(sc.rowp[((bc * a.n_kt + jt) * a.nh + h) * (long long)a.cl
                           + k]);
    u = double(sc.uu[hrow + k]);
    c = rs - double(sc.cols[hrow + k]) - u +
        double(decs[(s0 + k) * a.nh + h] * expf(float(sc.cs[hrow + k])));
  }
  const double usum = block_sum(u, red);
  if (t == 0)                             // the last token
    c += usum + double(detot[bc * a.nh + h] *
                       expf(float(sc.cs[hrow + a.cl - 1])));
  // inclusive scan over t = the sum over tokens >= k
  double v = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  __syncthreads();                        // red's last reads are done
  if (lane == 31) red[warp] = v;
  __syncthreads();
  double pre = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (w < warp) pre += red[w];
  const float dda = float(pre + v);
  float part = 0.f;
  if (on) {
    const long long i = (s0 + k) * a.nh + h;
    ddt[i] = sc.dot[hrow + k] + dda * A;
    part = dda * dt[i];
  }
  const double chunk_sum = block_sum(double(part), red);
  if (t == 0) sc.dap[bc * a.nh + h] = chunk_sum;
}

// ---------------------------------------------------------------------------
// 5. dA_log = A Σ over the chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_bwd_dalog_kernel(const float* __restrict__ A_log,
                     float* __restrict__ dA_log,
             Scratch sc, Args a) {
  __shared__ double red[WARPS];
  const int h = blockIdx.x;
  double v = 0.0;
  for (long long bc = threadIdx.x; bc < a.BC; bc += THREADS)
    v += sc.dap[bc * a.nh + h];
  v = block_sum(v, red);
  if (threadIdx.x == 0) dA_log[h] = float(v) * -expf(A_log[h]);
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

bool valid(int B, int S, int nh, int hp, int ns, int cl) {
  return B > 0 && S > 0 && nh > 0 && nh <= 65535 && cl > 0 &&
         cl <= MAX_CL && S % cl == 0 && hp > 0 && hp <= MAX_HP &&
         hp % 4 == 0 && ns > 0 && ns <= MAX_NS && ns % 4 == 0 &&
         (long long)B * (S / cl) <= 65535;
}

template <typename TI>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, const void* dy, const void* dst, const void* decs,
           const void* detot, void* dx, void* ddt, void* dA_log, void* dB,
           void* dC, void* scratch, int B, int S, int nh, int hp, int ns,
           int cl, cudaStream_t stream) {
  if (!valid(B, S, nh, hp, ns, cl)) return int(cudaErrorInvalidValue);
  Args a;
  a.nh = nh; a.hp = hp; a.ns = ns; a.cl = cl;
  a.n_kt = (cl + TILE - 1) / TILE;
  a.ldh = hp + 4; a.ldn = ns + 4;
  a.BC = (long long)B * (S / cl);
  const Scratch sc = carve(scratch, a.BC, nh, cl);
  const size_t s1 = head_smem(a), s2 = ds_smem(a), s3 = dbc_smem(a);
  if (s1 > size_t(MAX_SMEM) || s3 > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  cudaError_t e = allow_smem<ssd_bwd_head_kernel<TI>>(s1);
  if (e == cudaSuccess) e = allow_smem<ssd_bwd_ds_kernel<TI>>(s2);
  if (e == cudaSuccess) e = allow_smem<ssd_bwd_dbc_kernel<TI>>(s3);
  if (e != cudaSuccess) return int(e);
  const TI* xt = static_cast<const TI*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const TI* Bt = static_cast<const TI*>(Bm);
  const TI* Ct = static_cast<const TI*>(Cm);
  const int BC = int(a.BC);

  ssd_bwd_head_kernel<TI><<<dim3(a.n_kt, nh, BC), THREADS, s1, stream>>>(
      xt, dtf, al, Bt, Ct, static_cast<const float*>(dy),
      static_cast<const float*>(dst), static_cast<TI*>(dx), sc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  ssd_bwd_ds_kernel<TI><<<dim3(a.n_kt * (a.n_kt + 1) / 2, BC), THREADS, s2,
                  stream>>>(xt, dtf, static_cast<const float*>(dy), sc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  ssd_bwd_dbc_kernel<TI><<<dim3(2 * a.n_kt, BC), THREADS, s3, stream>>>(
      xt, dtf, Bt, Ct, static_cast<const float*>(dst), static_cast<TI*>(dB),
      static_cast<TI*>(dC), sc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  ssd_bwd_finish_kernel<<<dim3(nh, BC), THREADS, 0, stream>>>(
      dtf, al, static_cast<const float*>(decs),
      static_cast<const float*>(detot), static_cast<float*>(ddt), sc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  ssd_bwd_dalog_kernel<<<nh, THREADS, 0, stream>>>(
      al, static_cast<float*>(dA_log), sc, a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int ssd_bwd_bf16(const void* x, const void* dt, const void* A_log,
                 const void* Bm, const void* Cm, const void* dy,
                 const void* dst, const void* decs, const void* detot,
                 void* dx, void* ddt, void* dA_log, void* dB, void* dC,
                 void* scratch, int B, int S, int nh, int hp, int ns, int cl,
                 void* stream) {
  return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, dy, dst, decs, detot,
                               dx, ddt, dA_log, dB, dC, scratch, B, S, nh,
                               hp, ns, cl, static_cast<cudaStream_t>(stream));
}

int ssd_bwd_f32(const void* x, const void* dt, const void* A_log,
                const void* Bm, const void* Cm, const void* dy,
                const void* dst, const void* decs, const void* detot,
                void* dx, void* ddt, void* dA_log, void* dB, void* dC,
                void* scratch, int B, int S, int nh, int hp, int ns, int cl,
                void* stream) {
  return launch<float>(x, dt, A_log, Bm, Cm, dy, dst, decs, detot, dx, ddt,
                       dA_log, dB, dC, scratch, B, S, nh, hp, ns, cl,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of scratch a call at these shapes needs, or -1 for shapes the
// kernels do not take (or a buffer past 2 GB).
int ssd_bwd_workspace(int B, int S, int nh, int cl) {
  if (B <= 0 || S <= 0 || nh <= 0 || cl <= 0 || S % cl) return -1;
  const long long bytes = scratch_bytes((long long)B * (S / cl), nh, cl);
  return bytes > INT_MAX ? -1 : int(bytes);
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
