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
// about -480, where exp(cs_i) / exp(cs_j) would be 0/0. cs is accumulated
// in fp64 (dt * A is formed in fp32): cs_i - cs_j subtracts two sums of
// several hundred, and any fp32 order of the sum leaves ~1e-4 of rounding
// in that difference, which alone exceeds the tolerance below at cl = 256.
// The differences are rounded to fp32 before the exp.
//
// Inputs are contiguous: x (B, S, nh, hp), dt (B, S, nh) fp32, A_log (nh,)
// fp32, B/C (B, S, ns); x, B and C are bf16 or fp32 and are converted to
// fp32 in registers, so the caller makes no fp32 copy of them. S is a whole
// number of chunks. Outputs are fp32: y (B, nc, cl, nh, hp), states
// (B, nc, nh, hp, ns), exp_cs (B, nc, cl, nh), exp_tot (B, nc, nh).
//
// All other arithmetic is fp32 FMAs on the CUDA cores: the parity tests hold
// the pieces to atol 2e-5 / rtol 2e-4, which bf16 or TF32 tensor-core
// inputs cannot meet. Tensor cores are later work.
//
// What bounds it on the card: at zamba2-2.7b's prefill (B 4, S 512, cl 256,
// nh 80, hp 64, ns 64) the function needs ~4.1 GFLOP (C B^T once per chunk,
// the lower triangle of L (x dt), the states) and moves ~75 MB (x in bf16,
// y and states in fp32), so the fp32 rate bounds it: ~0.06 ms at 67 TFLOP/s
// against ~0.022 ms for the bytes.
//
// Design (one launch, two kinds of CTA, 256 threads each; blockIdx.y is the
// head, blockIdx.z the (batch, chunk)):
//   * y tiles: blockIdx.x < ceil(cl / 64) owns 64 rows i of the chunk. It
//     forms cs with a block-wide scan, keeps its rows of C transposed in
//     shared memory and walks only the key tiles j <= i of the lower
//     triangle: per tile it loads B (transposed) and x dt, forms the 64x64
//     block of C B^T (4x4 outputs a thread, float4 shared loads), multiplies
//     it by L, and accumulates y (64 x hp) in registers. It writes exp(cs)
//     of its rows. Heavy (late) row tiles are launched first.
//   * state tiles: the remaining blockIdx.x own one 64x64 tile of the
//     (hp, ns) states and walk every key tile of the chunk; the first also
//     writes exp(total).
// The Pallas body computes C B^T once per chunk for all heads; a y tile
// here recomputes it for its head, which keeps every CTA independent. At
// zamba2's shape the kernel does ~4.0 G FMAs (C B^T per head 1.7 G and y
// 1.7 G, both over 10 whole 64x64 tile pairs per (chunk, head); states
// 0.7 G) where the function needs ~2.0 G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TILE = 64;          // rows / keys / state columns per tile
constexpr int LDT = TILE + 4;     // row stride of transposed tiles (16 B)
constexpr int MAX_HP = 128;       // y keeps 4 x 8 accumulators a thread
constexpr int MAX_NS = 256;
constexpr float MASKED = -1e9f;   // the Pallas body's mask value

struct Args {
  int S, nh, hp, ns, cl, nc;
  int n_rt;                       // 64-row tiles of a chunk (y tiles)
  int n_pt, n_nt;                 // 64-wide tiles of hp and ns (states)
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

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

template <typename TI>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, void* y, void* st, void* ecs, void* etot, int B,
           int S, int nh, int hp, int ns, int cl, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || cl <= 0 || S % cl || hp <= 0 ||
      hp > MAX_HP || hp % 4 || ns <= 0 || ns > MAX_NS || nh > 65535 ||
      (long long)B * (S / cl) > 65535)
    return int(cudaErrorInvalidValue);
  Args a;
  a.S = S; a.nh = nh; a.hp = hp; a.ns = ns; a.cl = cl; a.nc = S / cl;
  a.n_rt = (cl + TILE - 1) / TILE;
  a.n_pt = (hp + TILE - 1) / TILE;
  a.n_nt = (ns + TILE - 1) / TILE;
  const size_t smem = smem_bytes(a);
  if (smem > 232448) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(a.n_rt + a.n_pt * a.n_nt, nh, B * a.nc);
  ssd_chunk_kernel<TI><<<grid, THREADS, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const TI*>(Bm),
      static_cast<const TI*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(ecs),
      static_cast<float*>(etot), a);
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

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
