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
// 1e-30 at the end, and the output is written in q's dtype. Where the
// caller passes an lse pointer (training), each row's log-sum-exp of the
// scaled scores, m + ln(max(l, 1e-30)) in natural-log units, is written
// beside the output as (B, H, S) fp32 for the backward
// (csrc/flash_bwd.cu); a null pointer (serving) writes none.
//
// What bounds it on the card: at the serving shapes (S = 512, hd = 64, bf16)
// the function moves ~33.5 MB and needs ~4.3 GFLOP (causal), so the data
// sheet puts it at the memory bound (~10 us at 3.35 TB/s); the products
// alone would take ~4.4 us at the bf16 tensor-core peak. Two kernels:
//
//   * bf16 (the serving path), built as the Hopper guide lays out a fast
//     kernel:
//       - TMA. The host encodes one CUtensorMap per q/k/v and column block
//         from the tensors' own strides, 4-D (hd, heads, seq, batch), so
//         nothing is transposed; a box is (cols, 1, rows, 1). TMA fills rows
//         past S or Sk with zeros (the masks still apply). hd 32 is one
//         64-byte-swizzled block, hd 64 one 128-byte block, hd 128 two, and
//         hd 80 (a 160-byte row, wider than the 128-byte swizzle) a 128-byte
//         block of 64 columns beside a 32-byte block of 16.
//       - A producer warp keeps a ring of WG_STAGES K/V tiles (64 keys
//         each) in flight, each stage with a "full" mbarrier the copies
//         complete and an "empty" one the consumer warps release.
//       - Consumer warpgroups of 64 q rows each run S = Q K^T as wgmma
//         m64n64k16 with Q and K from shared memory (K-major, one
//         instruction per 16 columns of hd), then O += P V with P packed to
//         bf16 in registers (the A operand) and V read MN-major from shared
//         memory (one instruction per column block per 16 keys).
//       - A CTA is one consumer warpgroup (64 q rows) and the producer
//         warp: 160 threads, ~3 CTAs an SM. A 128-row tile (two consumer
//         warpgroups) was slower at every head dim (PERF.md).
//     A warpgroup waits for its own products before the softmax, so within
//     a warpgroup the softmax does not overlap the tensor cores; the loads
//     overlap both.
//   * fp32: scalar fp32 FMAs out of shared memory (bound by shared-memory
//     issue), which keeps full fp32 accuracy (the tests hold fp32 to 2e-5,
//     beyond what bf16 or TF32 tensor-core inputs give).
//
// Common design:
//   * one CTA per (q tile, head, batch);
//   * the k loop visits only tiles that intersect the causal / window mask
//     (the rule of block_pairs in kernels/flash_attention/ref.py); the grid
//     visits every tile. In the bf16 kernel a warpgroup also skips the
//     tiles no row of its own may see, and masks only tiles on an edge;
//   * ragged edges are masked in the kernel: q rows >= S are not stored,
//     keys >= Sk are treated as masked (score -1e30, V row zero);
//   * heavy (late) causal q tiles are launched first to shorten the tail;
//   * head dims 32, 64, 80 (zamba2-2.7b) and 128. The fp32 tiles take
//     ~79 KB at hd 80.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // fp32: q rows per CTA
constexpr int BK = 64;            // fp32: keys per tile
constexpr float NEG_INF = -1e30f;

struct Args {
  int S, Sk, H, KH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, window;
};

// first and last tile of bk keys that meet the mask of q rows q0 ..
// min(q0 + rows, S) - 1
__device__ __forceinline__ void k_tile_range(const Args& a, int q0, int rows,
                                             int bk, int& lo, int& hi) {
  const int q_last = min(q0 + rows, a.S) - 1;
  lo = 0;
  hi = (a.Sk + bk - 1) / bk - 1;
  if (a.causal) hi = min(hi, q_last / bk);
  if (a.window) {
    const int first = q0 - a.window + 1;
    if (first > 0) lo = first / bk;
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
                     float* __restrict__ lse, Args a) {
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
  k_tile_range(a, q0, BQ, BK, j_lo, j_hi);

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
    if (lse != nullptr && c4 == 0)         // natural-log units here
      lse[(size_t(b) * a.H + h) * a.S + gq] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA loads into an mbarrier ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, wgmma .m64nNk16 with .f32 accumulators): warp
// w of a warpgroup holds rows 16w .. 16w + 15; with g = lane / 4 and
// t = lane % 4, registers 4j .. 4j + 3 hold (row g, cols 8j + 2t, 8j + 2t +
// 1) and (row g + 8, the same cols). Two neighbouring 8-key groups of the
// score accumulator packed to bf16 are exactly the register A fragment of
// the next product (P @ V), so P never leaves registers.

constexpr int WG_BK = 64;                  // keys a K/V tile
constexpr int WG_STAGES = 3;               // K/V tiles in flight

// A head_dim in column blocks, each one TMA box and one swizzle width (a
// row of 128, 64 or 32 bytes), stored [rows][cols] in its own piece of a
// tile: hd 32 = 32; 64 = 64; 80 = 64 + 16; 128 = 64 + 64.
template <int HD> struct Cols {
  static constexpr int NB = (HD == 80 || HD == 128) ? 2 : 1;
  __host__ __device__ static constexpr int width(int c) {
    return HD == 32 ? 32 : (HD == 80 && c == 1) ? 16 : 64;
  }
  __host__ __device__ static constexpr int off(int c) { return 64 * c; }
};

struct TmaMaps {                           // one box shape per column block
  CUtensorMap q[2], k[2], v[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a block whose rows are rb (128/64/32) bytes,
// swizzled as TMA wrote it: 8-row groups rb * 8 bytes apart (K-major A/B
// of S = Q K^T, and MN-major B of P V, where the 8-row groups step along
// the keys); the leading offset is unused at these widths
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int rb) {
  const uint64_t layout = rb == 128 ? 1 : (rb == 64 ? 2 : 3);
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t((8 * rb) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (cols, 1, rows, 1) of a (hd, heads, seq, batch) map at
// (col, head, row, batch); rows past seq arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64) = (scale_d ? d : 0) + a (shared, K-major) * b (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += a (registers, 64 x 16) * b (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += a (registers, 64 x 16) * b (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16) += a (registers, 64 x 16) * b (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int WG_ROWS = 64;       // bf16: q rows a CTA (one warpgroup)
constexpr int WG_THREADS = 128 + 32;

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return size_t(WG_ROWS) * HD * 2 + size_t(WG_STAGES) * 2 * WG_BK * HD * 2 +
         8 * (2 * WG_STAGES + 1) + 1024;   // + barriers, + 1024 alignment
}

// one consumer warpgroup (64 q rows) and one producer warp
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ TmaMaps maps,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      const Args a) {
  using C = Cols<HD>;
  constexpr int Q_BYTES = WG_ROWS * HD * 2;
  constexpr int KV_BYTES = WG_BK * HD * 2; // one K (or V) tile
  constexpr int STAGE = 2 * KV_BYTES;
  constexpr int NT = WG_BK / 8;            // 8-key groups a tile
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + Q_BYTES;     // [stage][K tile | V tile]
  const uint32_t bars = kv_s + WG_STAGES * STAGE;
  const uint32_t q_bar = bars + 16 * WG_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;
  int j_lo, j_hi;
  k_tile_range(a, q0, WG_ROWS, WG_BK, j_lo, j_hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);              // one arrival a consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: the q tile, then K/V tiles as the ring frees its stages
    if (lane == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NB; ++c)
        tma_load_4d(q_s + WG_ROWS * C::off(c) * 2, &maps.q[c], q_bar,
                    C::off(c), h, q0, b);
      for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) mbar_wait(empty(s), ((i / WG_STAGES) - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t kd = kv_s + s * STAGE, vd = kd + KV_BYTES;
#pragma unroll
        for (int c = 0; c < C::NB; ++c) {
          tma_load_4d(kd + WG_BK * C::off(c) * 2, &maps.k[c], full(s),
                      C::off(c), kh, jt * WG_BK, b);
          tma_load_4d(vd + WG_BK * C::off(c) * 2, &maps.v[c], full(s),
                      C::off(c), kh, jt * WG_BK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: q rows q0 .. q0 + 63 (every tile of the
  // range meets one of them)
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;   // this thread's two q rows
  const int row_b = row_a + 8;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);
  __syncwarp();

  for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
    const int s = i % WG_STAGES;
    const int k0 = jt * WG_BK;
    mbar_wait(full(s), (i / WG_STAGES) & 1);
    __syncwarp();                          // wgmma wants converged warps
    const uint32_t kd = kv_s + s * STAGE, vd = kd + KV_BYTES;

    // S = Q K^T, 64 rows x 64 keys, 16 columns of hd a step
    float sc[4 * NT];
#pragma unroll
    for (int n = 0; n < 4 * NT; ++n) sc[n] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (16 * kk) / 64;
      const int rb = C::width(c) * 2;
      const uint32_t col_b = (16 * kk - C::off(c)) * 2;
      const uint64_t da = gmma_desc(q_s + WG_ROWS * C::off(c) * 2 + col_b, rb);
      const uint64_t db = gmma_desc(kd + WG_BK * C::off(c) * 2 + col_b, rb);
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs<4 * NT>(sc);

    // mask (only where the tile meets an edge), scale, online softmax;
    // scores are kept in log2 units (scale * log2 e folded in), so each
    // exponential is one exp2f: exp2(x log2 e - m log2 e) = exp(x - m).
    // A masked score is -1e30 in either unit.
    const float scale2 = a.scale * 1.4426950408889634f;
    const bool inside = k0 + WG_BK <= a.Sk &&
                        (!a.causal || k0 + WG_BK - 1 <= q0) &&
                        (!a.window || k0 > q0 + 63 - a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e] * scale2;
        if (!inside) {
          const int gk = k0 + n * 8 + 2 * t + (e & 1);
          if (!allowed(a, e < 2 ? row_a : row_b, gk)) x = NEG_INF;
        }
        sc[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4 * NT; ++n) {
      sc[n] = exp2f(sc[n] - m[(n >> 1) & 1]);
      sum[(n >> 1) & 1] += sc[n];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i2 = 0; i2 < HD / 2; ++i2) acc[i2] *= corr[(i2 >> 1) & 1];

    // acc += P V: P packed to bf16 in registers, V read MN-major
    uint32_t pa[WG_BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < WG_BK / 16; ++kc) {
      const float* s0 = sc + 8 * kc;     // keys 16kc .. 16kc + 7
      const float* s1 = s0 + 4;          // keys 16kc + 8 .. 16kc + 15
      pa[kc][0] = pack_bf16(s0[0], s0[1]);
      pa[kc][1] = pack_bf16(s0[2], s0[3]);
      pa[kc][2] = pack_bf16(s1[0], s1[1]);
      pa[kc][3] = pack_bf16(s1[2], s1[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < WG_BK / 16; ++kc) {
      constexpr int rb0 = C::width(0) * 2, rb1 = C::width(1) * 2;
      wgmma_rs<C::width(0)>(acc, pa[kc],
                            gmma_desc(vd + 16 * kc * rb0, rb0));
      if constexpr (C::NB == 2)
        wgmma_rs<C::width(1)>(
            acc + C::off(1) / 2, pa[kc],
            gmma_desc(vd + WG_BK * C::off(1) * 2 + 16 * kc * rb1, rb1));
    }
    wgmma_commit_and_wait();
    fence_regs<HD / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // the stage may be refilled
  }

  const float inv_a = 1.f / fmaxf(l[0], 1e-30f);
  const float inv_b = 1.f / fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t == 0) {
    // m is in log2 units: lse = m ln 2 + ln(max(l, 1e-30))
    float* lb = lse + (size_t(b) * a.H + h) * a.S;
    if (row_a < a.S)
      lb[row_a] = m[0] * 0.6931471805599453f + logf(fmaxf(l[0], 1e-30f));
    if (row_b < a.S)
      lb[row_b] = m[1] * 0.6931471805599453f + logf(fmaxf(l[1], 1e-30f));
  }
  __nv_bfloat16* ob = o + b * a.o_sb + h * a.o_sh + 2 * t;
#pragma unroll
  for (int c = 0; c < C::NB; ++c) {
#pragma unroll
    for (int j = 0; j < C::width(c) / 8; ++j) {
      const float* r = acc + C::off(c) / 2 + 4 * j;
      const int col = C::off(c) + 8 * j;
      if (row_a < a.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * a.o_ss + col) =
            __floats2bfloat162_rn(r[0] * inv_a, r[1] * inv_a);
      if (row_b < a.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_b * a.o_ss + col) =
            __floats2bfloat162_rn(r[2] * inv_b, r[3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int launch_f32(void (*kernel)(const float*, const float*, const float*,
                              float*, float*, Args),
               size_t smem, const void* q, const void* k, const void* v,
               void* o, void* lse, int B, const Args& a,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), a);
  return int(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (hd, heads, seq, batch) view of a bf16 tensor with element strides
// (s_h, s_s, s_b), read in boxes of (cols, 1, rows, 1) at offset col0
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd,
              int heads, int seq, int batch, long long s_h, long long s_s,
              long long s_b, int cols, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 2, cuuint64_t(s_s) * 2,
                                 cuuint64_t(s_b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const int rb = cols * 2;
  const CUtensorMapSwizzle sw = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, const Args& a, cudaStream_t stream) {
  using C = Cols<HD>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  TmaMaps maps;
  for (int c = 0; c < 2; ++c) {            // block 1 repeats 0 at NB = 1
    const int w = C::width(c < C::NB ? c : 0);
    if (!make_map(encode, &maps.q[c], q, HD, a.H, a.S, B, a.q_sh, a.q_ss,
                  a.q_sb, w, WG_ROWS) ||
        !make_map(encode, &maps.k[c], k, HD, a.KH, a.Sk, B, a.k_sh, a.k_ss,
                  a.k_sb, w, WG_BK) ||
        !make_map(encode, &maps.v[c], v, HD, a.KH, a.Sk, B, a.v_sh, a.v_ss,
                  a.v_sb, w, WG_BK))
      return int(cudaErrorInvalidValue);
  }
  const size_t smem = bf16_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.S + WG_ROWS - 1) / WG_ROWS, a.H, B);
  flash_fwd_bf16_kernel<HD><<<grid, WG_THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), a);
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
                   void* lse, int B, int S, int Sk, int H, int KH, int hd,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh,
                   float scale, int causal, int window, void* stream) {
  if (bad_shape(B, S, Sk, H, KH)) return int(cudaErrorInvalidValue);
  // TMA: 16-byte aligned base addresses and strides
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
    case 32: return launch_bf16<32>(q, k, v, o, lse, B, a, st);
    case 64: return launch_bf16<64>(q, k, v, o, lse, B, a, st);
    case 80: return launch_bf16<80>(q, k, v, o, lse, B, a, st);
    case 128: return launch_bf16<128>(q, k, v, o, lse, B, a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int Sk, int H, int KH, int hd,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long o_sb, long long o_ss, long long o_sh,
                  float scale, int causal, int window, void* stream) {
  if (bad_shape(B, S, Sk, H, KH)) return int(cudaErrorInvalidValue);
  const Args a = make_args(S, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                           window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_f32(flash_fwd_f32_kernel<32>, f32_smem_bytes<32>(), q, k,
                        v, o, lse, B, a, st);
    case 64:
      return launch_f32(flash_fwd_f32_kernel<64>, f32_smem_bytes<64>(), q, k,
                        v, o, lse, B, a, st);
    case 80:
      return launch_f32(flash_fwd_f32_kernel<80>, f32_smem_bytes<80>(), q, k,
                        v, o, lse, B, a, st);
    case 128:
      return launch_f32(flash_fwd_f32_kernel<128>, f32_smem_bytes<128>(), q,
                        k, v, o, lse, B, a, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// the bf16 kernel's CTA at this head_dim, for reports: out = {threads,
// shared-memory bytes, CTAs an SM can hold}
int flash_fwd_bf16_plan(int hd, int* out) {
  int err = int(cudaErrorInvalidValue);
  auto fill = [&](auto kernel, size_t smem) {
    out[0] = WG_THREADS;
    out[1] = int(smem);
    err = int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    if (err == 0)
      err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], kernel, WG_THREADS, smem));
  };
  switch (hd) {
    case 32: fill(flash_fwd_bf16_kernel<32>, bf16_smem_bytes<32>()); break;
    case 64: fill(flash_fwd_bf16_kernel<64>, bf16_smem_bytes<64>()); break;
    case 80: fill(flash_fwd_bf16_kernel<80>, bf16_smem_bytes<80>()); break;
    case 128: fill(flash_fwd_bf16_kernel<128>, bf16_smem_bytes<128>()); break;
  }
  return err;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
