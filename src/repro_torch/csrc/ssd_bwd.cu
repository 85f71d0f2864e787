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
// the JAX comment at mamba.py:118 warns of), only loaded K dimensions are
// summed (every tile is zero-filled past its rows and columns), and
// cs_i - cs_j is an fp64 difference rounded to fp32 before the exp.
//
// Inputs are contiguous: x (B, S, nh, hp), B/C (B, S, ns) in bf16 or fp32,
// dt (B, S, nh) and A_log (nh,) fp32; dy (B, nc, cl, nh, hp), dst (B, nc,
// nh, hp, ns), decs (B, nc, cl, nh), detot (B, nc, nh) fp32. Outputs: dx,
// dB, dC in the inputs' dtype, ddt and dA_log fp32. hp and ns are
// multiples of 4, hp <= 64, ns <= 128, cl <= 256 (every training shape);
// the bf16 instance wants every input on 16 bytes (the wrapper copies one
// that is not). The plain twins are ref.ssd_chunk_bwd_ref and, for the
// bf16 instance's split arithmetic, ref.ssd_chunk_bwd_split_ref.
//
// Deterministic, with no atomics: every sum over heads, tiles or chunks
// runs in a fixed order, through fp32/fp64 partials in a scratch buffer
// the wrapper allocates (ssd_bwd_workspace bytes). One C entry point per
// dtype; both end with the same two kernels:
//
//  * ssd_bwd_finish_kernel, a CTA per (head, batch · chunk), one thread
//    a token: dcs in fp64 from the row partials of r (one a key tile),
//    the column sums of r, u and dxdt · x, its reverse cumsum by a block
//    scan, ddt, and the chunk's Σ d(dt A) dt;
//  * ssd_bwd_dalog_kernel, a CTA a head: dA_log = A Σ over the chunks, in
//    order.
//
// bf16 (the training path): products on the tensor cores, mma.sync
// m16n8k16 (mma_sync.cuh, shared with the forward). mma.sync, not wgmma:
// every product here is 64 rows by at most 128 columns, several of them
// take an A operand made in registers from an accumulator (P), and they
// are interleaved with per-element work on those accumulators, which the
// m16n8 fragments hold per thread; wgmma would need a warpgroup-wide
// 64-row tile per product and its asynchrony buys nothing at this size.
// x, B and C are bf16, so exact; a product of two bf16 values is exact in
// fp32, so each fp32 operand is split into bf16 pieces (hi = bf16(v),
// mid = bf16(v - hi), lo = bf16(v - hi - mid)) and each piece multiplied
// by an exact operand, fp32 sums:
//   - s = C·Bᵀ: one pass (both exact);
//   - g_ij = dt_j (dy_i · x_j): dy in two pieces, x exact, dt_j applied
//     to the fp32 sum;
//   - dst B_j, and x_j · dst (the states' dB term, scaled by w_j dt_j
//     after): dst in two pieces;
//   - dC = ds B and dsᵀ C: ds in two pieces;
//   - dxdt_j += Σ_i P_ij dy_i: P and dy both fp32, each in three pieces,
//     the six products of piece m and piece n with m + n < 3.
// The piece counts come from the CPU twin (ref.ssd_chunk_bwd_split_ref,
// tests/test_torch_ssd_grad.py): at cl 256 one unsplit pass misses the
// 1e-4 tolerance ten to forty times over; two pieces on Pᵀ·dy use about a
// tenth of it (ddt), three about 3.5%; two pieces on the one-exact
// products use at most 3%.
//
//  1. ssd_bwd_scan_kernel, a warp per (head, batch · chunk): cs in fp64
//     into scratch, once (the fp32 instance scans in every key-tile CTA).
//  2. ssd_bwd_mma_head_kernel, a CTA of 8 warps per (64-key tile jt, group
//     of GROUP = 8 heads, batch · chunk); jt varies fastest, so the CTAs
//     that read one group's dy tiles run together. Warp w owns keys
//     16 (w % 4) .. + 16 and, of each 64-row tile, rows 32 (w / 4) .. + 32.
//     Everything runs in the transposed frame (rows = keys j, columns =
//     rows i), where the accumulator of Pᵀ is the A operand of Pᵀ·dy.
//     First it forms sᵀ for every row tile it >= jt once, into shared
//     memory (fp32, in fragment order: each thread rereads its own).
//     Then it walks the group's heads (heads outside the row tiles): per
//     head dst B_j (which starts dxdt), u_j's part and x_j · dst (added,
//     times w_j dt_j, to the group's states' dB term in registers); per
//     row tile gᵀ, then per element L (ex2.approx, 2e-7 relative), P,
//     r = P g and the group's ds partial in shared memory (ds += L g,
//     thread-private, heads in order), the row sums of r (one partial a
//     (jt, row)), the column sums (in shared memory, by the lane that
//     owns the key), and dxdt += Pᵀ dy with P split in registers.
//     A warp holds its 32 rows' share of each key's dxdt; the two halves
//     are summed through shared memory at the head's end (a + b, so the
//     order does not matter), then dx, the column sums, u and dxdt · x
//     go out. The next head's x, dst, cs and dt arrive by cp.async while
//     the current head runs, its dy tiles by loads into registers one row
//     tile ahead. Last the group's ds partials and states' dB partial go
//     to scratch. Shared memory at hp 64, ns 128, cl 256: the sᵀ and ds
//     tiles 128 KB, B_j 17 KB, x_j 9 KB, dy's three planes 27 KB, dst's
//     two 34 KB: one CTA an SM. Registers: 255 a thread, no spills. hp
//     (32 or 64) and the states' dB tiles (ns <= 64 or 128) are template
//     constants, so shared-memory offsets are immediates; the dy
//     prefetch addresses are formed behind an opaque 0, which keeps ptxas
//     from hoisting them out of the row-tile loop; cs_j and dt_j are
//     reread from shared memory and the column sums of r kept there (a
//     build that holds those in registers runs faster but spills:
//     tools/ssd_bwd_variants.py, PERF.md).
//  3. ssd_bwd_dsum_kernel, a CTA per (tile pair, batch · chunk): ds = Σ
//     over the groups of their partials, in order, into two bf16 pieces.
//  4. ssd_bwd_mma_dbc_kernel, a CTA per (role, column half, batch ·
//     chunk): dC for a row tile (Σ over key tiles of ds B) or dB for a
//     key tile (Σ over row tiles of dsᵀ C, then the groups' states'
//     terms in order); roles ordered heaviest first. The columns are
//     split in two where 2 n_kt · batch · chunks CTAs would not fill the
//     card (zamba2-2.7b's training call: 128).
//
// GROUP = 8: the ds partial is cl²·4 bytes a (chunk, group) (its lower
// triangle of 64 x 64 tiles, 160 KB at cl 256), so at zamba2-2.7b's call
// (nh 80, 16 chunks) the groups' partials are 26 MB written and read once
// by the dsum kernel, against 210 MB at one head a CTA, and its grid is
// 4 x 10 x 16 = 640 CTAs of unequal work (4:3:2:1 by jt) on 132 SMs;
// mamba2-130m (nh 24, 32 chunks) 384; groups are ragged where nh is not
// a multiple of 8 (the tests' nh of 2 to 4 make one group). Heads walk in
// sequence, so GROUP costs no shared memory or registers.
//
// fp32 (the tests' yardstick, not on the training path): the first
// design, fp32 FMAs on the CUDA cores, 256 threads a CTA, each thread
// 4 x 4 outputs of a 64 x 64 tile:
//  1. ssd_bwd_head_kernel, a CTA per (64-key tile jt, head, batch ·
//     chunk): the fp64 scan of cs (written to scratch by jt = 0), dst B_j,
//     u_j, then for each row tile it >= jt the tiles s, g, P and r, and
//     dxdt_j += Pᵀ dy_i. Writes dx, the row and column sums of r, u and
//     dxdt · x.
//  2. ssd_bwd_ds_kernel, a CTA per (row tile, key tile) pair on or below
//     the diagonal and (batch · chunk): ds = Σ_h L ⊙ g over the heads in
//     order, into scratch.
//  3. ssd_bwd_dbc_kernel, a CTA per (role, batch · chunk): dC for a row
//     tile, or dB for a key tile (then the heads' w xdt dstᵀ in order).
//
// What bounds it: at zamba2-2.7b's training call (x (1, 4096, 80, 64),
// ns 64, cl 256, bf16) the function moves ~195 MB (the fp32 dy alone is
// 84 MB, x and dx 42 MB each): ~0.058 ms at 3.35 TB/s. Its ~16.7 GFLOP
// take ~0.034 ms at the 495 TFLOP/s TF32 tensor-core rate: bytes bound it
// (chip_smoke.ssd_bwd_work counts both). The bf16 kernels take ~0.65 ms
// there, the head kernel ~85% of it (PERF.md). What holds them above the
// bound: the split passes (gᵀ two, Pᵀ·dy six, dst B_j and x_j · dst two
// each) make ~65 GFLOP of bf16 products (chip_smoke.ssd_bwd_mma_work),
// ~0.07 ms at 989 TFLOP/s, of which mma.sync reaches a part; the
// per-element work (an fp64 difference, a conversion and an exp a head
// and element, the three-piece split of P); one 8-warp CTA an SM (the sᵀ
// and ds tiles fill shared memory), whose warps move through each row
// tile's products, element work and two barriers in step, so the tensor
// cores and the other pipes take turns; dy read once for each key tile
// at or below its row tile (~2.5 times, from L2 when the CTAs of one
// group run together).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "mma_sync.cuh"

namespace {

constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;          // rows / keys a tile
constexpr int LDT = TILE + 4;     // row stride of 64-wide tiles (16 B)
constexpr int MAX_HP = 64;
constexpr int MAX_NS = 128;
constexpr int MAX_CL = THREADS;   // the finish kernel: one thread a token
constexpr int MAX_SMEM = 232448;  // a block's shared memory, bytes
constexpr int GROUP = 8;          // heads a CTA of the bf16 head kernel
constexpr int PAIR = TILE * TILE; // elements of a (row tile, key tile) pair

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
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Args {
  int nh, hp, ns, cl, n_kt;
  int ldh, ldn;                   // hp + 4, ns + 4: row strides (16 B)
  long long BC;                   // batch · chunks
  int hpp, nsp;                   // bf16: hp and ns rounded up to 32
  int ngrp, npairs;               // bf16: head groups, tile pairs a chunk
  int nsplit;                     // bf16: column halves of the dC/dB grid
};

// the scratch buffer, carved in this order, each part on 16 bytes; the
// tail is the fp32 instance's ds or the bf16 instance's partials
struct Scratch {
  double* cs;                     // (BC, nh, cl)  cs of each head
  double* dap;                    // (BC, nh)      Σ_k d(dt A)_k dt_k
  float* rowp;                    // (BC, n_kt, nh, cl) row sums of r, by jt
  float* cols;                    // (BC, nh, cl)  column sums of r
  float* uu;                      // (BC, nh, cl)  u
  float* dot;                     // (BC, nh, cl)  dxdt · x
  float* ds;                      // fp32: (BC, cl, cl) (0 above the diagonal)
  float* dsp;                     // bf16: (BC, ngrp, npairs, 64, 64) the
                                  //   groups' ds partials, [i][j] a pair
  float* dbst;                    // bf16: (BC, ngrp, cl, MAX_NS) the
                                  //   groups' states' dB terms
  __nv_bfloat16* dspl;            // bf16: (BC, npairs, 2, 64, 64) ds, the
                                  //   groups summed, in two bf16 pieces
};

// Byte offsets of the parts (base 0), and the total.
struct Carving {
  long long cs, dap, rowp, cols, uu, dot, tail, dbst, dspl, total;
};

Carving carving(long long BC, int nh, int cl) {
  const long long n_kt = (cl + TILE - 1) / TILE;
  const long long ngrp = (nh + GROUP - 1) / GROUP;
  const long long npairs = n_kt * (n_kt + 1) / 2;
  Carving c;
  long long off = 0;
  auto take = [&off](long long bytes) {
    const long long at = off;
    off = (off + bytes + 15) & ~15LL;
    return at;
  };
  c.cs = take(8 * BC * nh * cl);
  c.dap = take(8 * BC * nh);
  c.rowp = take(4 * BC * n_kt * nh * cl);
  c.cols = take(4 * BC * nh * cl);
  c.uu = take(4 * BC * nh * cl);
  c.dot = take(4 * BC * nh * cl);
  const long long head = off;
  c.tail = take(4 * BC * ngrp * npairs * PAIR);
  c.dbst = take(4 * BC * ngrp * cl * MAX_NS);
  c.dspl = take(2 * BC * npairs * 2 * PAIR);
  const long long bf16_end = off;
  const long long f32_end = (head + 4 * BC * cl * cl + 15) & ~15LL;
  c.total = bf16_end > f32_end ? bf16_end : f32_end;
  return c;
}

Scratch carve(void* base, long long BC, int nh, int cl) {
  const Carving c = carving(BC, nh, cl);
  char* b = static_cast<char*>(base);
  Scratch s;
  s.cs = reinterpret_cast<double*>(b + c.cs);
  s.dap = reinterpret_cast<double*>(b + c.dap);
  s.rowp = reinterpret_cast<float*>(b + c.rowp);
  s.cols = reinterpret_cast<float*>(b + c.cols);
  s.uu = reinterpret_cast<float*>(b + c.uu);
  s.dot = reinterpret_cast<float*>(b + c.dot);
  s.ds = reinterpret_cast<float*>(b + c.tail);
  s.dsp = reinterpret_cast<float*>(b + c.tail);
  s.dbst = reinterpret_cast<float*>(b + c.dbst);
  s.dspl = reinterpret_cast<__nv_bfloat16*>(b + c.dspl);
  return s;
}

// ===========================================================================
// the fp32 instance (fp32 FMAs) and the two kernels both instances end with
// ===========================================================================

// cs[i] = sum_{k <= i} dt[k * nh] * A (fp64) for i < n, into shared memory,
// by a block-wide scan (csrc/ssd_chunk.cu's scalar kernel's chunk_cumsum).
// Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int nh,
                                             float A, int n,
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
__device__ __forceinline__ double block_sum(double v, double* red) {
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

__global__ void __launch_bounds__(THREADS)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A_log, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ dy,
            const float* __restrict__ dst, float* __restrict__ dx, Scratch sc,
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

__global__ void __launch_bounds__(THREADS)
ssd_bwd_ds_kernel(const float* __restrict__ x, const float* __restrict__ dt,
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

__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[4][8],
                                           long long row0,
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

__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ dst, float* __restrict__ dB,
           float* __restrict__ dC, Scratch sc, Args a) {
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


// ===========================================================================
// the bf16 instance: products on the tensor cores
// ===========================================================================

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;            // bf16 row padding: ldmatrix conflict-free
constexpr int PE = 2;             // pieces of an fp32 operand by an exact one
constexpr int PB = 3;             // pieces of each operand of Pᵀ·dy
constexpr int HT = 256;           // threads of the head and dC/dB kernels

__host__ __device__ inline int round32(int v) { return (v + 31) & ~31; }

// The head kernel's shared memory: byte offsets and the total.
struct HeadSmem {
  int s, ds, b, x, dy, dst, cs, dtk, red, ex, total;
};

__host__ __device__ inline HeadSmem mma_head_smem(const Args& a) {
  const int BS = a.nsp + PAD, XS = a.hpp + PAD;
  HeadSmem m;
  int off = 0;
  auto take = [&off](int bytes) {
    const int at = off;
    off = (off + bytes + 127) & ~127;
    return at;
  };
  m.s = take(a.n_kt * PAIR * 4);          // sᵀ tiles, fragment order
  m.ds = take(a.n_kt * PAIR * 4);         // the group's ds partials
  m.b = take(TILE * BS * 2);              // B_j
  m.x = take(TILE * XS * 2);              // x_j of a head
  // dy's three planes; first the C_i tiles, last the dxdt exchange
  const int dy3 = PB * TILE * XS * 2, ctile = TILE * BS * 2;
  m.dy = take(dy3 > ctile ? dy3 : ctile);
  m.dst = take(2 * a.hpp * BS * 2);       // dst's two planes, or fp32 dst
  m.cs = take(2 * a.cl * 8);              // cs of a head, two buffers
  m.dtk = take(2 * TILE * 4);             // dt of the keys, two buffers
  m.red = take(4 * TILE * 4);             // row sums of r, by key warp
  m.ex = take(6 * TILE * 4);              // u, column sums, dxdt · x halves
  m.total = off;
  return m;
}

// A 64-row bf16 tile into shared memory (row stride sstride) by 8-byte
// cp.async: rows < rows and columns < cols of src (row stride gstride),
// the rest of the wpad columns zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, int sstride,
                                          const bf16* src,
                          long long gstride, int rows, int cols, int wpad) {
  const int cpr = wpad / 4;
  for (int e = threadIdx.x; e < TILE * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e - r * cpr) * 4;
    const bool v = r < rows && c < cols;
    cp_async_small<8>(dst + r * sstride + c, v ? src + r * gstride + c : src,
                      v);
  }
}

// dst of a head, fp32 [hpp][nsp + PAD] in shared memory (as cp.async left
// it, zero past hp and ns), into two bf16 planes [hpp][nsp + PAD] in the
// same bytes (hi, then mid), once every thread's copies have landed
// (cp_async_wait and a barrier before it). Ends with a barrier.
__device__ __forceinline__ void dst_planes(bf16* planes, int nsp, int hpp) {
  const float* f = reinterpret_cast<const float*>(planes);
  const int BS = nsp + PAD, cpr = nsp / 4;
  float4 v[MAX_HP * MAX_NS / 4 / HT];
#pragma unroll
  for (int k = 0; k < MAX_HP * MAX_NS / 4 / HT; ++k) {
    const int e = threadIdx.x + HT * k, r = e / cpr, c = (e - r * cpr) * 4;
    if (r < hpp) v[k] = *reinterpret_cast<const float4*>(f + r * BS + c);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_HP * MAX_NS / 4 / HT; ++k) {
    const int e = threadIdx.x + HT * k, r = e / cpr, c = (e - r * cpr) * 4;
    if (r >= hpp) continue;
    uint32_t h01, m01, h23, m23;
    split2(v[k].x, v[k].y, h01, m01);
    split2(v[k].z, v[k].w, h23, m23);
    *reinterpret_cast<uint2*>(planes + r * BS + c) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(planes + (hpp + r) * BS + c) =
        make_uint2(m01, m23);
  }
  __syncthreads();
}

// dst of head h (hp x ns fp32) into shared memory as [hpp][nsp + PAD] fp32
// by 16-byte cp.async, zero-filled past hp and ns
__device__ __forceinline__ void load_dst(float* dstf, const float* dsth,
                                         int hp, int ns, int hpp, int nsp) {
  const int BS = nsp + PAD, cpr = nsp / 4;
  for (int e = threadIdx.x; e < hpp * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e - r * cpr) * 4;
    const bool v = r < hp && c < ns;
    cp_async16(dstf + r * BS + c, v ? dsth + r * ns + c : dsth, v);
  }
}

// cs[k] = Σ_{k' <= k} dt[k'] A (fp64) of one (batch · chunk, head), a
// warp each: lanes scan consecutive segments, joined by a shuffle scan
__global__ void __launch_bounds__(HT)
ssd_bwd_scan_kernel(const float* __restrict__ dt,
                    const float* __restrict__ A_log, Scratch sc, Args a) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * (HT / 32) + (threadIdx.x >> 5);
  if (h >= a.nh) return;                  // whole warps
  const long long bc = blockIdx.y;
  const float A = -expf(A_log[h]);
  const float* dtp = dt + bc * a.cl * a.nh + h;
  double* cs = sc.cs + (bc * a.nh + h) * (long long)a.cl;
  const int per = (a.cl + 31) >> 5;
  const int k0 = min(lane * per, a.cl), k1 = min(k0 + per, a.cl);
  double inc = 0.0;
  for (int k = k0; k < k1; ++k) inc += double(dtp[(long long)k * a.nh] * A);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  double run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) run = 0.0;
  for (int k = k0; k < k1; ++k) {
    run += double(dtp[(long long)k * a.nh] * A);
    cs[k] = run;
  }
}

// HPP: hp rounded up to 32; NQN_MAX: 8-wide n tiles in a half of ns (4 for
// ns <= 64, else 8). Constants, so that shared-memory offsets in the
// unrolled products are immediates and the accumulators fit the registers.
template <int HPP, int NQN_MAX>
__global__ void __launch_bounds__(HT, 1)
ssd_bwd_mma_head_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A_log,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm,
                        const float* __restrict__ dy,
                        const float* __restrict__ dst, bf16* __restrict__ dx,
                        Scratch sc, Args a) {
  extern __shared__ __align__(128) char smem[];
  const HeadSmem L = mma_head_smem(a);
  float4* Rs = reinterpret_cast<float4*>(smem + L.s);
  float4* Rds = reinterpret_cast<float4*>(smem + L.ds);
  bf16* RB = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Rx = reinterpret_cast<bf16*>(smem + L.x);
  bf16* Rdy = reinterpret_cast<bf16*>(smem + L.dy);
  bf16* Rdst = reinterpret_cast<bf16*>(smem + L.dst);
  float* Rdstf = reinterpret_cast<float*>(smem + L.dst);
  double* Rcs = reinterpret_cast<double*>(smem + L.cs);
  float* Rdtk = reinterpret_cast<float*>(smem + L.dtk);
  float* Rred = reinterpret_cast<float*>(smem + L.red);
  float* Rex = reinterpret_cast<float*>(smem + L.ex);  // [u|col|dot][2][64]

  const int jt = blockIdx.x, grp = blockIdx.y;
  const long long bc = blockIdx.z, s0 = bc * a.cl;
  const int h0 = grp * GROUP, nhg = min(GROUP, a.nh - h0);
  const int j0 = jt * TILE, keys = min(TILE, a.cl - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp & 3, nw = warp >> 2;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, r8 = lane & 7;
  constexpr int XS = HPP + PAD, PL = TILE * XS;  // dy's row stride, plane
  constexpr int NQP = HPP / 16;           // 8-wide p tiles in a half (2, 4)
  constexpr int DYF = HPP * TILE / 4 / HT;        // dy float4s a thread
  constexpr int CPR_LOG = HPP == 64 ? 4 : 3;      // log2 float4s a dy row
  const int BS = a.nsp + PAD;
  const int DPL = HPP * BS;               // elements of a dst plane
  const int NQN = a.nsp / 16;             // 8-wide n tiles in a half (2..8)
  const int ja = 16 * mw + g, jb = ja + 8;  // this thread's keys in the tile

  // the inputs of head hh of the group, by cp.async (one commit group):
  // x_j, dst (fp32, row stride BS), cs and the keys' dt
  auto prefetch_head = [&](int hh) {
    const int h = h0 + hh, buf = hh & 1;
    load_tile(Rx, XS, x + ((s0 + j0) * a.nh + h) * a.hp,
              (long long)a.nh * a.hp, keys, a.hp, HPP);
    load_dst(Rdstf, dst + (bc * a.nh + h) * (long long)a.hp * a.ns, a.hp,
             a.ns, HPP, a.nsp);
    const double* csh = sc.cs + (bc * a.nh + h) * (long long)a.cl;
    for (int i = tid; i < a.cl; i += HT)
      cp_async_small<8>(Rcs + buf * a.cl + i, csh + i, true);
    if (tid < TILE)
      cp_async_small<4>(Rdtk + buf * TILE + tid,
                        dt + (s0 + j0 + min(tid, keys - 1)) * a.nh + h,
                        tid < keys);
    cp_async_commit();
  };

  // dy rows [64 it, 64 it + 64) of head h into registers, zero past the
  // chunk and hp; then into shared memory as three bf16 planes
  float4 pf[DYF];
  auto load_dy = [&](int h, int it) {
    // an opaque 0 in the row index keeps ptxas from hoisting these 64-bit
    // addresses out of the row-tile loop (they would be spilled)
    int salt;
    asm volatile("mov.b32 %0, 0;" : "=r"(salt));
    const int i0 = it * TILE, rows = min(TILE, a.cl - i0), nhp = a.nh * a.hp;
    const float* dyh = dy + (s0 * a.nh + h) * (long long)a.hp;
#pragma unroll
    for (int k = 0; k < DYF; ++k) {
      const int e = tid + HT * k, r = e >> CPR_LOG;
      const int c = (e - (r << CPR_LOG)) * 4;
      pf[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < a.hp)
        pf[k] = *reinterpret_cast<const float4*>(dyh + (i0 + r + salt) * nhp +
                                                 c);
    }
  };
  auto store_dy = [&]() {
#pragma unroll
    for (int k = 0; k < DYF; ++k) {
      const int e = tid + HT * k, r = e >> CPR_LOG;
      const int c = (e - (r << CPR_LOG)) * 4;
      if (r >= TILE) continue;
      uint32_t h01, m01, l01, h23, m23, l23;
      split3(pf[k].x, pf[k].y, h01, m01, l01);
      split3(pf[k].z, pf[k].w, h23, m23, l23);
      bf16* p = Rdy + r * XS + c;
      *reinterpret_cast<uint2*>(p) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(p + PL) = make_uint2(m01, m23);
      *reinterpret_cast<uint2*>(p + 2 * PL) = make_uint2(l01, l23);
    }
  };

  // --- B_j, the first head's inputs, ds partials to 0, sᵀ for every row
  // tile at or below the diagonal (C_i staged in dy's space)
  load_tile(RB, BS, Bm + (s0 + j0) * a.ns, a.ns, keys, a.ns, a.nsp);
  cp_async_commit();
  prefetch_head(0);
  for (int e = tid; e < (a.n_kt - jt) * PAIR / 4; e += HT)
    Rds[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  load_dy(h0, jt);
  for (int it = jt; it < a.n_kt; ++it) {
    const int i0 = it * TILE;
    __syncthreads();                      // the previous C tile is consumed
    load_tile(Rdy, BS, Cm + (s0 + i0) * a.ns, a.ns, min(TILE, a.cl - i0),
              a.ns, a.nsp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sacc[4][4] = {};
    for (int ks = 0; ks < a.nsp / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, RB + (16 * mw + (m8 & 1) * 8 + r8) * BS + 16 * ks +
                      (m8 >> 1) * 8);
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Rdy + (32 * nw + 8 * q + (m8 >> 1) * 8 + r8) * BS +
                         16 * ks + (m8 & 1) * 8);
        mma16816(sacc[q], af, bfr[0], bfr[1]);
        mma16816(sacc[q + 1], af, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      Rs[(((it - jt) * 8 + warp) * 4 + q) * 32 + lane] =
          make_float4(sacc[q][0], sacc[q][1], sacc[q][2], sacc[q][3]);
  }
  __syncthreads();                        // the C tiles are consumed
  store_dy();

  float dB[NQN_MAX][4] = {};              // the group's states' dB term:
                                          // keys ja/jb, n = nsp/2 nw + 8 q
  for (int hh = 0; hh < nhg; ++hh) {
    const int h = h0 + hh, buf = hh & 1;
    const long long hrow = (bc * a.nh + h) * (long long)a.cl;
    cp_async_wait<0>();
    __syncthreads();                      // this head's inputs are in
    dst_planes(Rdst, a.nsp, HPP);
    const double* cs = Rcs + buf * a.cl;
    const float* dtk = Rdtk + buf * TILE;
    const double tot = cs[a.cl - 1];
    const double csa = cs[min(j0 + ja, a.cl - 1)];
    const double csb = cs[min(j0 + jb, a.cl - 1)];
    const float dta = dtk[ja], dtb = dtk[jb];        // 0 past the keys
    const float wa = expf(float(tot - csa)), wb = expf(float(tot - csb));
    const float ca = wa * dta, cb = wb * dtb;
    // x_j's A fragments, and from them x_j at key ja (r = 0) or jb (r = 1)
    // and p = 8 (NQP nw + q) + 2t, + 1 (this warp's half of p, as
    // accumulators hold it) by a select on nw, so that register indices
    // stay constants
    uint32_t xa[NQP][4];
#pragma unroll
    for (int kq = 0; kq < NQP; ++kq)
      ldsm_x4(xa[kq], Rx + (16 * mw + (m8 & 1) * 8 + r8) * XS + 16 * kq +
                          (m8 >> 1) * 8);
    auto xo = [&](int q, int r) {
      const int reg = (q & 1) * 2 + r;
      return nw ? xa[NQP / 2 + q / 2][reg] : xa[q / 2][reg];
    };

    // dst B_j on this warp's half of p: dxdt starts as w_j dst B_j; u_j's
    // part Σ_p x_j dst B_j. dxr[k] holds dxdt's 8-wide p tile NQP nw + k
    // for k < NQP (this warp's half) and NQP (1 - nw) + k - NQP above (so
    // that every register index is a constant)
    float dxr[2 * NQP][4] = {};           // dxdt: keys ja/jb
    float ua = 0.f, ub = 0.f;
    {
      float d[4][4] = {};
      for (int ks = 0; ks < a.nsp / 16; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, RB + (16 * mw + (m8 & 1) * 8 + r8) * BS + 16 * ks +
                        (m8 >> 1) * 8);
#pragma unroll
        for (int pl = 0; pl < PE; ++pl)
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            if (q >= NQP) continue;
            uint32_t bfr[4];
            ldsm_x4(bfr, Rdst + pl * DPL +
                             (nw * (HPP / 2) + 8 * q + (m8 >> 1) * 8 + r8) *
                                 BS +
                             16 * ks + (m8 & 1) * 8);
            mma16816(d[q], af, bfr[0], bfr[1]);
            mma16816(d[q + 1], af, bfr[2], bfr[3]);
          }
      }
#pragma unroll
      for (int q = 0; q < NQP; ++q) {
        ua += d[q][0] * lo_f(xo(q, 0)) + d[q][1] * hi_f(xo(q, 0));
        ub += d[q][2] * lo_f(xo(q, 1)) + d[q][3] * hi_f(xo(q, 1));
        dxr[q][0] = wa * d[q][0];
        dxr[q][1] = wa * d[q][1];
        dxr[q][2] = wb * d[q][2];
        dxr[q][3] = wb * d[q][3];
      }
    }
    // the states' dB term: + w_j dt_j (x_j · dst) on this warp's half of n,
    // four 8-wide n tiles at a time
#pragma unroll
    for (int q0 = 0; q0 < NQN_MAX; q0 += 4) {
      float qa[4][4] = {};
#pragma unroll
      for (int kq = 0; kq < NQP; ++kq)
#pragma unroll
        for (int pl = 0; pl < PE; ++pl)
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            if (q0 + q >= NQN) continue;
            uint32_t r[4];
            ldsm_x4_t(r, Rdst + pl * DPL +
                             (16 * kq + (m8 & 1) * 8 + r8) * BS +
                             nw * (a.nsp / 2) + 8 * (q0 + q) + (m8 >> 1) * 8);
            mma16816(qa[q], xa[kq], r[0], r[1]);
            mma16816(qa[q + 1], xa[kq], r[2], r[3]);
          }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dB[q0 + q][0] = fmaf(ca, qa[q][0], dB[q0 + q][0]);
        dB[q0 + q][1] = fmaf(ca, qa[q][1], dB[q0 + q][1]);
        dB[q0 + q][2] = fmaf(cb, qa[q][2], dB[q0 + q][2]);
        dB[q0 + q][3] = fmaf(cb, qa[q][3], dB[q0 + q][3]);
      }
    }
    ua += __shfl_xor_sync(0xffffffffu, ua, 1);
    ua += __shfl_xor_sync(0xffffffffu, ua, 2);
    ub += __shfl_xor_sync(0xffffffffu, ub, 1);
    ub += __shfl_xor_sync(0xffffffffu, ub, 2);
    if (t == 0) {
      Rex[nw * TILE + ja] = ua;
      Rex[nw * TILE + jb] = ub;
    }
    __syncthreads();                      // x_j and dst are read
    if (hh + 1 < nhg) prefetch_head(hh + 1);

    // the column sums of r (Σ_i r, keys ja / jb) accumulate in shared
    // memory, a k step at a time, by the lane t = 0 that owns the key
    if (t == 0) {
      Rex[2 * TILE + nw * TILE + ja] = 0.f;
      Rex[2 * TILE + nw * TILE + jb] = 0.f;
    }
    for (int it = jt; it < a.n_kt; ++it) {
      const int i0 = it * TILE;
      const bool last = it + 1 == a.n_kt;
      if (!last)
        load_dy(h, it + 1);
      else if (hh + 1 < nhg)
        load_dy(h + 1, jt);

      // gᵀ = x_j · dy_i (dt_j applied below): keys ja/jb, rows
      // i = 32 nw + 8 q + 2t (+ 1)
      float gacc[4][4] = {};
#pragma unroll
      for (int kq = 0; kq < NQP; ++kq) {
#pragma unroll
        for (int pl = 0; pl < PE; ++pl)
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            uint32_t bfr[4];
            ldsm_x4(bfr, Rdy + pl * PL +
                             (32 * nw + 8 * q + (m8 >> 1) * 8 + r8) * XS +
                             16 * kq + (m8 & 1) * 8);
            mma16816(gacc[q], xa[kq], bfr[0], bfr[1]);
            mma16816(gacc[q + 1], xa[kq], bfr[2], bfr[3]);
          }
      }

      // per element: L, P = s L, r = P g, ds += L g; then P, in three
      // bf16 pieces, is the A operand of dxdt += Pᵀ dy over this warp's 32
      // rows (pieces m of P and n of dy with m + n < PB), a 16-row k step
      // at a time (accumulator tiles 2 kk and 2 kk + 1)
      const int tile = it - jt;
      const float4* sf = Rs + ((tile * 8 + warp) * 4) * 32 + lane;
      float4* dsf = Rds + ((tile * 8 + warp) * 4) * 32 + lane;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[PB][4];
        float cola = 0.f, colb = 0.f;
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int q = 2 * kk + hq;
          const float4 s4 = sf[q * 32];
          const float4 d4 = dsf[q * 32];
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          float dv[4] = {d4.x, d4.y, d4.z, d4.w};
          const int ic = i0 + 32 * nw + 8 * q + 2 * t;
          const double ci[2] = {cs[min(ic, a.cl - 1)],
                                cs[min(ic + 1, a.cl - 1)]};
          float pv[4], rv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ic + (e & 1), j = j0 + (e < 2 ? ja : jb);
            float Lv = 0.f;               // ex2.approx: 2e-7 relative
            if (j <= i && i < a.cl)
              Lv = __expf(float(ci[e & 1] -
                                cs[min(j0 + (e < 2 ? ja : jb), a.cl - 1)]));
            // cs_j and dt_j reread from shared memory: in registers across
            // the row tiles they would be spilled
            const float gv = gacc[q][e] * dtk[e < 2 ? ja : jb];
            pv[e] = sv[e] * Lv;
            rv[e] = pv[e] * gv;
            dv[e] = fmaf(Lv, gv, dv[e]);
          }
          dsf[q * 32] = make_float4(dv[0], dv[1], dv[2], dv[3]);
          cola += rv[0] + rv[1];
          colb += rv[2] + rv[3];
          split3(pv[0], pv[1], pa[0][2 * hq], pa[1][2 * hq], pa[2][2 * hq]);
          split3(pv[2], pv[3], pa[0][2 * hq + 1], pa[1][2 * hq + 1],
                 pa[2][2 * hq + 1]);
          // the row sums of r over this warp's 16 keys (then over key
          // warps, below)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = rv[c] + rv[c + 2];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) Rred[mw * TILE + 32 * nw + 8 * q + 2 * t + c] = v;
          }
        }
        cola += __shfl_xor_sync(0xffffffffu, cola, 1);
        cola += __shfl_xor_sync(0xffffffffu, cola, 2);
        colb += __shfl_xor_sync(0xffffffffu, colb, 1);
        colb += __shfl_xor_sync(0xffffffffu, colb, 2);
        if (t == 0) {
          Rex[2 * TILE + nw * TILE + ja] += cola;
          Rex[2 * TILE + nw * TILE + jb] += colb;
        }
#pragma unroll
        for (int kp = 0; kp < NQP; ++kp) {   // pairs of dxr tiles
          const int np = 2 * kp < NQP ? NQP * nw + 2 * kp
                                      : NQP * (1 - nw) + 2 * kp - NQP;
#pragma unroll
          for (int pl = 0; pl < PB; ++pl) {
            uint32_t r[4];
            ldsm_x4_t(r, Rdy + pl * PL +
                             (32 * nw + 16 * kk + (m8 & 1) * 8 + r8) * XS +
                             8 * np + (m8 >> 1) * 8);
#pragma unroll
            for (int m = 0; m + pl < PB; ++m) {
              mma16816(dxr[2 * kp], pa[m], r[0], r[1]);
              mma16816(dxr[2 * kp + 1], pa[m], r[2], r[3]);
            }
          }
        }
      }
      __syncthreads();                    // dy's planes are read; Rred is full
      if (tid < TILE && i0 + tid < a.cl)
        sc.rowp[((bc * a.n_kt + jt) * a.nh + h) * (long long)a.cl + i0 +
                tid] = Rred[tid] + Rred[TILE + tid] + Rred[2 * TILE + tid] +
                       Rred[3 * TILE + tid];
      if (!last) {
        store_dy();
        __syncthreads();
      }
    }

    // --- the head's end: the two halves of dxdt summed through shared
    // memory (dy's space), dx, and the keys' column sums, u, dxdt · x
    float4* xch = reinterpret_cast<float4*>(Rdy);   // [mw][half][q][lane]
#pragma unroll
    for (int k = NQP; k < 2 * NQP; ++k)   // the other half's tiles
      xch[((mw * 2 + 1 - nw) * NQP + k - NQP) * 32 + lane] =
          make_float4(dxr[k][0], dxr[k][1], dxr[k][2], dxr[k][3]);
    __syncthreads();
    float dota = 0.f, dotb = 0.f;
#pragma unroll
    for (int q = 0; q < NQP; ++q) {
      const float4 o = xch[((mw * 2 + nw) * NQP + q) * 32 + lane];
      const float v0 = dxr[q][0] + o.x, v1 = dxr[q][1] + o.y;
      const float v2 = dxr[q][2] + o.z, v3 = dxr[q][3] + o.w;
      dota += v0 * lo_f(xo(q, 0)) + v1 * hi_f(xo(q, 0));
      dotb += v2 * lo_f(xo(q, 1)) + v3 * hi_f(xo(q, 1));
      const int p = 8 * (NQP * nw + q) + 2 * t;
      if (p < a.hp) {
        bf16* out = dx + ((s0 + j0) * a.nh + h) * a.hp + p;
        const long long row = (long long)a.nh * a.hp;
        if (ja < keys)
          *reinterpret_cast<__nv_bfloat162*>(out + ja * row) =
              __floats2bfloat162_rn(v0 * dta, v1 * dta);
        if (jb < keys)
          *reinterpret_cast<__nv_bfloat162*>(out + jb * row) =
              __floats2bfloat162_rn(v2 * dtb, v3 * dtb);
      }
    }
    dota += __shfl_xor_sync(0xffffffffu, dota, 1);
    dota += __shfl_xor_sync(0xffffffffu, dota, 2);
    dotb += __shfl_xor_sync(0xffffffffu, dotb, 1);
    dotb += __shfl_xor_sync(0xffffffffu, dotb, 2);
    if (t == 0) {
      Rex[4 * TILE + nw * TILE + ja] = dota;
      Rex[4 * TILE + nw * TILE + jb] = dotb;
    }
    __syncthreads();                      // the exchange and Rex are done
    if (tid < keys) {
      const long long k = hrow + j0 + tid;
      const float c = expf(float(tot - cs[j0 + tid])) * dtk[tid];
      sc.uu[k] = (Rex[tid] + Rex[TILE + tid]) * c;
      sc.cols[k] = Rex[2 * TILE + tid] + Rex[3 * TILE + tid];
      sc.dot[k] = Rex[4 * TILE + tid] + Rex[5 * TILE + tid];
    }
    if (hh + 1 < nhg) store_dy();         // the next head's first dy tile
  }

  // --- the group's ds partials ([i][j] a tile pair) and states' dB term
  float* dsp = sc.dsp + (bc * a.ngrp + grp) * (long long)a.npairs * PAIR;
  for (int it = jt; it < a.n_kt; ++it) {
    float* tp = dsp + (long long)(it * (it + 1) / 2 + jt) * PAIR;
    const float4* dsf = Rds + (((it - jt) * 8 + warp) * 4) * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = dsf[q * 32];
      const int il = 32 * nw + 8 * q + 2 * t;
      tp[il * TILE + ja] = v.x;
      tp[(il + 1) * TILE + ja] = v.y;
      tp[il * TILE + jb] = v.z;
      tp[(il + 1) * TILE + jb] = v.w;
    }
  }
  float* db = sc.dbst + ((bc * a.ngrp + grp) * (long long)a.cl + j0) * MAX_NS;
#pragma unroll
  for (int q = 0; q < NQN_MAX; ++q) {
    const int n = nw * (a.nsp / 2) + 8 * q + 2 * t;
    if (q >= NQN || n >= a.ns) continue;
    if (ja < keys)
      *reinterpret_cast<float2*>(db + ja * MAX_NS + n) =
          make_float2(dB[q][0], dB[q][1]);
    if (jb < keys)
      *reinterpret_cast<float2*>(db + jb * MAX_NS + n) =
          make_float2(dB[q][2], dB[q][3]);
  }
}

// ds of a tile pair: Σ over the groups' partials in order, as two bf16
// pieces [i][j]
__global__ void __launch_bounds__(HT)
ssd_bwd_dsum_kernel(Scratch sc, Args a) {
  const int pair = blockIdx.x;
  const long long bc = blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(
      sc.dsp + (bc * a.ngrp * (long long)a.npairs + pair) * PAIR);
  const long long gstride = (long long)a.npairs * PAIR / 4;
  bf16* out = sc.dspl + (bc * a.npairs + pair) * 2LL * PAIR;
  for (int e = threadIdx.x; e < PAIR / 4; e += HT) {
    float4 s = src[e];
    for (int gi = 1; gi < a.ngrp; ++gi) {
      const float4 v = src[gi * gstride + e];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    uint32_t h01, m01, h23, m23;
    split2(s.x, s.y, h01, m01);
    split2(s.z, s.w, h23, m23);
    *reinterpret_cast<uint2*>(out + 4 * e) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(out + PAIR + 4 * e) = make_uint2(m01, m23);
  }
}

__host__ __device__ inline int mma_dbc_smem(const Args& a) {
  return 2 * (2 * TILE * (TILE + PAD) + TILE * (a.nsp / a.nsplit + PAD));
}

// dC for a row tile (roles [0, n_kt), the last row tile first) or dB for a
// key tile (roles [n_kt, 2 n_kt), the first first), on the columns
// [n0, n0 + nsp / nsplit); warp w: rows 16 (w % 4) .. + 16, the (w / 4)-th
// half of those columns
__global__ void __launch_bounds__(HT, 1)
ssd_bwd_mma_dbc_kernel(const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, bf16* __restrict__ dB,
                       bf16* __restrict__ dC, Scratch sc, Args a) {
  extern __shared__ __align__(128) char smem[];
  constexpr int DS = TILE + PAD;
  bf16* Dp = reinterpret_cast<bf16*>(smem);       // [2][64][DS]: ds pieces
  bf16* Ms = Dp + 2 * TILE * DS;                  // [64][MS]: B or C rows
  const int ncols = a.nsp / a.nsplit, MS = ncols + PAD;
  const int role = blockIdx.x, n0 = blockIdx.y * ncols;
  const long long bc = blockIdx.z, s0 = bc * a.cl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp & 3, wc = (warp >> 2) * (ncols / 2);
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, r8 = lane & 7;
  const int NQ = ncols / 16;              // 8-wide column tiles a warp
  const bool is_dc = role < a.n_kt;
  const int tile = is_dc ? a.n_kt - 1 - role : role - a.n_kt;
  const int r0 = tile * TILE, nrows = min(TILE, a.cl - r0);
  float acc[8][4] = {};
  for (int o = is_dc ? 0 : tile; o <= (is_dc ? tile : a.n_kt - 1); ++o) {
    const int it = is_dc ? tile : o, jt = is_dc ? o : tile;
    const int m0 = o * TILE;
    __syncthreads();                      // the previous tiles are consumed
    const bf16* src = sc.dspl + (bc * a.npairs + it * (it + 1) / 2 + jt) *
                                    2LL * PAIR;
    for (int e = tid; e < 2 * TILE * (TILE / 8); e += HT) {
      const int r = e / (TILE / 8), c = (e - r * (TILE / 8)) * 8;
      // r: piece · 64 + row
      cp_async16(Dp + r * DS + c, src + r * TILE + c, true);
    }
    load_tile(Ms, MS, (is_dc ? Bm : Cm) + (s0 + m0) * a.ns + n0, a.ns,
              min(TILE, a.cl - m0), a.ns - n0, ncols);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks)
#pragma unroll
      for (int pl = 0; pl < PE; ++pl) {
        const bf16* D = Dp + pl * TILE * DS;
        uint32_t af[4];
        if (is_dc)                        // A = ds: rows i, k = j
          ldsm_x4(af, D + (16 * mw + (m8 & 1) * 8 + r8) * DS + 16 * ks +
                          (m8 >> 1) * 8);
        else                              // A = dsᵀ: rows j, k = i
          ldsm_x4_t(af, D + (16 * ks + (m8 >> 1) * 8 + r8) * DS + 16 * mw +
                            (m8 & 1) * 8);
#pragma unroll
        for (int q = 0; q < 8; q += 2) {
          if (q >= NQ) continue;
          uint32_t r[4];
          ldsm_x4_t(r, Ms + (16 * ks + (m8 & 1) * 8 + r8) * MS + wc + 8 * q +
                           (m8 >> 1) * 8);
          mma16816(acc[q], af, r[0], r[1]);
          mma16816(acc[q + 1], af, r[2], r[3]);
        }
      }
  }
  const int ra = 16 * mw + g, rb = ra + 8;
  bf16* out = is_dc ? dC : dB;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = n0 + wc + 8 * q + 2 * t;
    if (q >= NQ || n >= a.ns) continue;
    float v[4] = {acc[q][0], acc[q][1], acc[q][2], acc[q][3]};
    if (!is_dc)                           // + the groups' states' terms
      for (int gi = 0; gi < a.ngrp; ++gi) {
        const float* db = sc.dbst + ((bc * a.ngrp + gi) * (long long)a.cl +
                                     r0) * MAX_NS + n;
        if (ra < nrows) {
          const float2 u = *reinterpret_cast<const float2*>(db + ra * MAX_NS);
          v[0] += u.x;
          v[1] += u.y;
        }
        if (rb < nrows) {
          const float2 u = *reinterpret_cast<const float2*>(db + rb * MAX_NS);
          v[2] += u.x;
          v[3] += u.y;
        }
      }
    if (ra < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (s0 + r0 + ra) * a.ns + n) =
          __floats2bfloat162_rn(v[0], v[1]);
    if (rb < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (s0 + r0 + rb) * a.ns + n) =
          __floats2bfloat162_rn(v[2], v[3]);
  }
}

}  // namespace tc

// ===========================================================================
// dispatch
// ===========================================================================

bool valid(int B, int S, int nh, int hp, int ns, int cl) {
  return B > 0 && S > 0 && nh > 0 && nh <= 65535 && cl > 0 &&
         cl <= MAX_CL && S % cl == 0 && hp > 0 && hp <= MAX_HP &&
         hp % 4 == 0 && ns > 0 && ns <= MAX_NS && ns % 4 == 0 &&
         (long long)B * (S / cl) <= 65535;
}

// One kernel launch of a call: the kernel, its grid, threads and dynamic
// shared memory, and what grants it that shared memory.
struct Launch {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
  cudaError_t (*allow)(size_t);
};

template <auto Kern>
Launch launch_of(dim3 grid, int threads, size_t smem) {
  return {reinterpret_cast<const void*>(Kern), grid, threads, smem,
          allow_smem<Kern>};
}

// The launches of a call, in order (n of them), and its Args; false for
// shapes the kernels do not take.
bool plan(int B, int S, int nh, int hp, int ns, int cl, bool bf16, int sms,
          Args& a, Launch (&L)[6], int& n) {
  if (!valid(B, S, nh, hp, ns, cl)) return false;
  a.nh = nh; a.hp = hp; a.ns = ns; a.cl = cl;
  a.n_kt = (cl + TILE - 1) / TILE;
  a.ldh = hp + 4; a.ldn = ns + 4;
  a.BC = (long long)B * (S / cl);
  a.hpp = tc::round32(hp); a.nsp = tc::round32(ns);
  a.ngrp = (nh + GROUP - 1) / GROUP;
  a.npairs = a.n_kt * (a.n_kt + 1) / 2;
  a.nsplit = 2 * a.n_kt * a.BC < sms && a.nsp % 64 == 0 ? 2 : 1;
  const int BC = int(a.BC);
  const dim3 fin(nh, BC), dal(nh);
  if (bf16) {
    const size_t head = tc::mma_head_smem(a).total;
    if (head > size_t(MAX_SMEM)) return false;
    using tc::ssd_bwd_mma_head_kernel;
    const dim3 hg(a.n_kt, a.ngrp, BC);
    L[0] = launch_of<tc::ssd_bwd_scan_kernel>(
        dim3((nh + tc::HT / 32 - 1) / (tc::HT / 32), BC), tc::HT, 0);
    L[1] = a.hpp == 64
               ? (a.nsp <= 64
                      ? launch_of<ssd_bwd_mma_head_kernel<64, 4>>(hg, tc::HT,
                                                                  head)
                      : launch_of<ssd_bwd_mma_head_kernel<64, 8>>(hg, tc::HT,
                                                                  head))
               : (a.nsp <= 64
                      ? launch_of<ssd_bwd_mma_head_kernel<32, 4>>(hg, tc::HT,
                                                                  head)
                      : launch_of<ssd_bwd_mma_head_kernel<32, 8>>(hg, tc::HT,
                                                                  head));
    L[2] = launch_of<tc::ssd_bwd_dsum_kernel>(dim3(a.npairs, BC), tc::HT, 0);
    L[3] = launch_of<tc::ssd_bwd_mma_dbc_kernel>(
        dim3(2 * a.n_kt, a.nsplit, BC), tc::HT, tc::mma_dbc_smem(a));
    n = 4;
  } else {
    const size_t s1 = head_smem(a), s3 = dbc_smem(a);
    if (s1 > size_t(MAX_SMEM) || s3 > size_t(MAX_SMEM)) return false;
    L[0] = launch_of<ssd_bwd_head_kernel>(dim3(a.n_kt, nh, BC), THREADS, s1);
    L[1] = launch_of<ssd_bwd_ds_kernel>(
        dim3(a.n_kt * (a.n_kt + 1) / 2, BC), THREADS, ds_smem(a));
    L[2] = launch_of<ssd_bwd_dbc_kernel>(dim3(2 * a.n_kt, BC), THREADS, s3);
    n = 3;
  }
  L[n++] = launch_of<ssd_bwd_finish_kernel>(fin, THREADS, 0);
  L[n++] = launch_of<ssd_bwd_dalog_kernel>(dal, THREADS, 0);
  return true;
}

cudaError_t card_sms(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

int launch(bool bf16, const void* x, const void* dt, const void* A_log,
           const void* Bm, const void* Cm, const void* dy, const void* dst,
           const void* decs, const void* detot, void* dx, void* ddt,
           void* dA_log, void* dB, void* dC, void* scratch, int B, int S,
           int nh, int hp, int ns, int cl, cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = card_sms(sms);
  if (e != cudaSuccess) return int(e);
  Args a;
  Launch L[6];
  int n = 0;
  if (!plan(B, S, nh, hp, ns, cl, bf16, sms, a, L, n))
    return int(cudaErrorInvalidValue);
  for (int k = 0; k < n && e == cudaSuccess; ++k) e = L[k].allow(L[k].smem);
  if (e != cudaSuccess) return int(e);
  const Scratch sc = carve(scratch, a.BC, nh, cl);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* dyf = static_cast<const float*>(dy);
  const float* dstf = static_cast<const float*>(dst);
  int k = 0;
  auto next = [&]() -> const Launch& { return L[k++]; };
  if (bf16) {
    using bf = __nv_bfloat16;
    const bf* xb = static_cast<const bf*>(x);
    const bf* Bb = static_cast<const bf*>(Bm);
    const bf* Cb = static_cast<const bf*>(Cm);
    const Launch* l = &next();
    tc::ssd_bwd_scan_kernel<<<l->grid, l->threads, l->smem, stream>>>(
        dtf, al, sc, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    l = &next();                          // the head kernel's instance
    bf* dxb = static_cast<bf*>(dx);
    Scratch scv = sc;
    void* hargs[] = {&xb, &dtf, &al, &Bb, &Cb, &dyf, &dstf, &dxb, &scv, &a};
    e = cudaLaunchKernel(l->fn, l->grid, dim3(l->threads), hargs, l->smem,
                         stream);
    if (e != cudaSuccess) return int(e);

    l = &next();
    tc::ssd_bwd_dsum_kernel<<<l->grid, l->threads, l->smem, stream>>>(sc, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    l = &next();
    tc::ssd_bwd_mma_dbc_kernel<<<l->grid, l->threads, l->smem, stream>>>(
        Bb, Cb, static_cast<bf*>(dB), static_cast<bf*>(dC), sc, a);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* Bf = static_cast<const float*>(Bm);
    const float* Cf = static_cast<const float*>(Cm);
    const Launch* l = &next();
    ssd_bwd_head_kernel<<<l->grid, l->threads, l->smem, stream>>>(
        xf, dtf, al, Bf, Cf, dyf, dstf, static_cast<float*>(dx), sc, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    l = &next();
    ssd_bwd_ds_kernel<<<l->grid, l->threads, l->smem, stream>>>(xf, dtf, dyf,
                                                                sc, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    l = &next();
    ssd_bwd_dbc_kernel<<<l->grid, l->threads, l->smem, stream>>>(
        xf, dtf, Bf, Cf, dstf, static_cast<float*>(dB),
        static_cast<float*>(dC), sc, a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  const Launch* l = &next();
  ssd_bwd_finish_kernel<<<l->grid, l->threads, l->smem, stream>>>(
      dtf, al, static_cast<const float*>(decs),
      static_cast<const float*>(detot), static_cast<float*>(ddt), sc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  l = &next();
  ssd_bwd_dalog_kernel<<<l->grid, l->threads, l->smem, stream>>>(
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
  return launch(true, x, dt, A_log, Bm, Cm, dy, dst, decs, detot, dx, ddt,
                dA_log, dB, dC, scratch, B, S, nh, hp, ns, cl,
                static_cast<cudaStream_t>(stream));
}

int ssd_bwd_f32(const void* x, const void* dt, const void* A_log,
                const void* Bm, const void* Cm, const void* dy,
                const void* dst, const void* decs, const void* detot,
                void* dx, void* ddt, void* dA_log, void* dB, void* dC,
                void* scratch, int B, int S, int nh, int hp, int ns, int cl,
                void* stream) {
  return launch(false, x, dt, A_log, Bm, Cm, dy, dst, decs, detot, dx, ddt,
                dA_log, dB, dC, scratch, B, S, nh, hp, ns, cl,
                static_cast<cudaStream_t>(stream));
}

// Bytes of scratch a call at these shapes needs (either dtype), or -1 for
// shapes the kernels do not take (or a buffer past 2 GB).
int ssd_bwd_workspace(int B, int S, int nh, int cl) {
  if (B <= 0 || S <= 0 || nh <= 0 || cl <= 0 || S % cl) return -1;
  const long long bytes = carving((long long)B * (S / cl), nh, cl).total;
  return bytes > INT_MAX ? -1 : int(bytes);
}

// The launches of a call at these shapes, into out: out[0] = n kernels,
// out[1] = heads a CTA of the bf16 head kernel, out[2] = column splits of
// its dC/dB kernel, out[3] = the card's SMs, then for each kernel in
// launch order CTAs, threads, dynamic shared memory bytes, registers a
// thread, local memory (spill) bytes a thread, CTAs resident an SM.
int ssd_bwd_plan(int B, int S, int nh, int hp, int ns, int cl, int bf16,
                 int* out) {
  int sms = 0;
  cudaError_t e = card_sms(sms);
  if (e != cudaSuccess) return int(e);
  Args a;
  Launch L[6];
  int n = 0;
  if (!plan(B, S, nh, hp, ns, cl, bf16 != 0, sms, a, L, n))
    return int(cudaErrorInvalidValue);
  out[0] = n;
  out[1] = bf16 ? GROUP : 1;
  out[2] = bf16 ? a.nsplit : 1;
  out[3] = sms;
  for (int k = 0; k < n; ++k) {
    cudaFuncAttributes fa;
    int per_sm = 0;
    e = L[k].allow(L[k].smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, L[k].fn);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, L[k].fn, L[k].threads, L[k].smem);
    if (e != cudaSuccess) return int(e);
    int* o = out + 4 + 6 * k;
    o[0] = int(L[k].grid.x * L[k].grid.y * L[k].grid.z);
    o[1] = L[k].threads;
    o[2] = int(L[k].smem);
    o[3] = fa.numRegs;
    o[4] = int(fa.localSizeBytes);
    o[5] = per_sm;
  }
  return 0;
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
