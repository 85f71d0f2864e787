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
// table's slots, as the Pallas kernel does. Softmax is fp32; l is clamped
// to 1e-30; the output is written in q's dtype.
//
// What bounds it on the card: by the data sheet, bytes. A decode step
// reads every cached K/V byte of the sequence once and does 4 FLOPs per
// byte-pair, far below the card's ~295 FLOP/byte balance point; at B=4,
// 32 KV heads, hd 64 and 543 cached tokens a call reads ~17.8 MB (~5.3 us
// at 3.35 TB/s). To come near that, every SM needs tens of kilobytes in
// flight (3.35 TB/s x ~1 us of latency over 132 SMs is ~25 KB an SM), so
// the design spreads the bytes over many CTAs and issues them all before
// the first use. What bounds it now is the order of the phases: all CTAs
// are resident in one wave and run in step, so the card first streams the
// bytes, then every SM does its CTAs' arithmetic on fp32 CUDA cores at
// once (instruction issue, not bytes, sets that phase's length), then
// the CTAs merge; only the scores overlap the V copies. PERF.md has the
// times.
//
// Design:
//   * the G query rows of a KV head are cut into R = ceil(G / Gmax) row
//     tiles of Gt = ceil(G / R) rows, Gmax = the rows whose fp32 sums fit
//     the registers (Gt * hd <= 1024: 8 rows at hd 128); the last tile's
//     missing rows are zeros and are not stored. granite-34b's 48 rows
//     over one KV head at hd 128 are 6 tiles of 8. Each tile reads its KV
//     head's pages itself
//     (R reads of each page, mostly from L2 after the first);
//   * a cluster of n_split CTAs per (row tile, kv head, sequence); CTA s
//     owns the logical pages [s * pps, (s + 1) * pps) with pps =
//     ceil(nblk / 8) and n_split = ceil(nblk / pps) <= 8 (the portable
//     cluster size). The split depends on nblk only: 34 pages give 7 CTAs
//     of 5 pages, 896 CTAs at the serving shape;
//   * each CTA copies its pages' K rows, then their V rows, into shared
//     memory with 16-byte cp.async, as two copy groups with every copy in
//     flight at once: the scores start when K has landed, while V is still
//     in flight. A stage holds up to 32 KB of K+V (the whole split at the
//     serving shapes); longer splits run a two-stage ring;
//   * inside a CTA, warp w takes the stage's tokens w, w + 4, ...; for
//     scores, a group of lg lanes shares a token row, lane i reading its
//     16-byte chunks i, i + lg, ... (lg = the chunk count rounded up to a
//     power of two: hd 64 bf16 is 8 chunks on 8 lanes, 4 tokens a warp
//     instruction; hd 80 is 10 chunks on 16 lanes, lanes 10-15 idle, 2
//     tokens an instruction); for P.V, lane (tl, col) owns one 16-byte
//     column chunk of one query row and the tokens k = tl, tl + TL, ... of
//     the warp, with TL = 32 / (G * chunks) (4 at hd 64, 3 at hd 80);
//   * the serving shapes (G = 1, hd 64 or 80 in bf16) run instances with
//     G and the chunk count as constants: every index split by them is
//     then a shift or a multiply, which shortens the arithmetic phase;
//   * each warp keeps its own online-softmax (m, l) per query row and its
//     lanes' partial sums; the CTA merges its warps and lanes into its
//     partial (m, l, acc) in its own shared memory. After a cluster
//     barrier (every CTA is running and has written its partial) the
//     leader reads the partials through distributed shared memory and
//     merges them in split order, each weighted by exp(m_s - M); a second
//     barrier keeps the other CTAs alive until it has read them. Splits
//     without a valid position are not dropped: with every position
//     masked they weigh 1 each, which keeps the zero-length row equal to
//     the mean of V;
//   * with lengths[b] > 0, tokens at or beyond the length are not summed:
//     their weight would be exactly 0, so the bits do not change. A zero
//     length sums every slot. Pages are loaded before the length is known
//     (the table and length reads overlap), so a table longer than the
//     length costs bytes;
//   * every reduction order is a function of shapes and logical positions
//     only, never of the physical page index or the lengths' values, and no
//     atomics are used: the same pages under a permuted table give
//     bit-identical output.
//   * rows whose 16-byte chunks are not 16-byte aligned (hd not a multiple
//     of 8 bf16 / 4 fp32 values, or odd strides) are copied element by
//     element instead of by cp.async, into the same zero-padded layout.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLIT = 8;               // portable cluster size
constexpr int STAGE_BYTES = 32 * 1024;     // K + V bytes of one stage
constexpr int MAX_ROW_ELEMS = 1024;        // Gt * hd, a row tile
#ifndef PAGED_MAX_TILE_ROWS                // -D to time smaller row tiles
#define PAGED_MAX_TILE_ROWS 0              // 0: as many as MAX_ROW_ELEMS
#endif
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

// one 16-byte chunk of T as VEC floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  // n 16-byte loads of floats (shared q rows)
  __device__ static void load4(const float* p, float* f, int n) {
#pragma unroll
    for (int i = 0; i < n; ++i) load(p + 4 * i, f + 4 * i);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* table;
  const int* lengths;
  void* out;
  int G;             // query rows a CTA (a row tile)
  int G_all;         // query rows a KV head
  int R;             // row tiles a KV head: ceil(G_all / G)
  int hd, page_sz, nblk;
  int pps;           // logical pages per split (per CTA)
  int stage_pages;   // pages per shared-memory stage
  int n_bufs;        // 1, or 2 for a ring when a split has several stages
  int chunks;        // 16-byte chunks per row: ceil(hd / VEC)
  int lg;            // lanes per token row in the score step
  int aligned;       // rows may be copied with 16-byte cp.async
  long long q_sb, q_sh, k_sp, k_st, k_sh, v_sp, v_st, v_sh, t_sb, o_sb, o_sh;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__host__ __device__ inline size_t up4(size_t x) {
  return (x + 3) & ~size_t(3);
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int r = 1;
  while (r < x) r <<= 1;
  return r;
}

// shared-memory carve-up, in floats then T (16-byte aligned pieces);
// chunks (16-byte chunks a row) and G are constants in the specialised
// kernels
struct Layout {
  int RS, TS, TW, n_cols, part_w;
  size_t qs, sc, wm, wl, wc, cm, cl, cacc, n_f, kv_bytes;
  __host__ __device__ Layout(const Params& p, int vec, int chunks, int G) {
    RS = chunks * vec;                     // padded row, elements
    TS = p.stage_pages * p.page_sz;        // tokens a stage
    TW = (TS + WARPS - 1) / WARPS;         // tokens a warp a stage
    n_cols = G * chunks;
    part_w = (n_cols > 32 ? n_cols : 32) * vec;
    qs = 0;
    sc = qs + up4(size_t(G) * RS);
    wm = sc + up4(size_t(WARPS) * G * TW);
    wl = wm + up4(size_t(WARPS) * G);
    wc = wl + up4(size_t(WARPS) * G);
    cm = wc + up4(size_t(WARPS) * G);    // the CTA's partial: m [G],
    cl = cm + up4(size_t(G));            // l [G],
    cacc = cl + up4(size_t(G));          // acc [G][RS]
    n_f = cacc + up4(size_t(G) * RS);
    // K/V stages; once they are consumed, the lanes' partial sums
    // [WARPS][part_w] floats take their place
    const size_t kv = size_t(p.n_bufs) * 2 * TS * RS * (16 / vec);
    const size_t parts = size_t(WARPS) * part_w * sizeof(float);
    kv_bytes = kv > parts ? kv : parts;
  }
};

// the rows of one head of n_pg logical pages from pg_lo on (K or V) into
// a stage buffer, all copies in flight at once, as one copy group
template <typename T>
__device__ __forceinline__ void load_rows(const Params& p, const T* pool,
                                          long long s_page, long long s_tok,
                                          long long s_head, T* dst,
                                          const int* trow, int kh, int pg_lo,
                                          int n_pg, int chunks) {
  constexpr int VEC = Vec<T>::N;
  const int RS = chunks * VEC;
  // page ids eight at a time, their loads issued together; then each
  // page's rows, one 16-byte chunk a thread and copy
  const int per_page = p.page_sz * (p.aligned ? chunks : RS);
  for (int j0 = 0; j0 < n_pg; j0 += 8) {
    long long page[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      page[u] = j0 + u < n_pg ? __ldg(trow + pg_lo + j0 + u) : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (j0 + u >= n_pg) break;
      const T* src = pool + page[u] * s_page + kh * s_head;
      T* d0 = dst + (j0 + u) * p.page_sz * RS;
      for (int i = threadIdx.x; i < per_page; i += THREADS) {
        if (p.aligned) {
          const int t = i / chunks, c = i - t * chunks;
          cp_async16(d0 + t * RS + c * VEC, src + t * s_tok + c * VEC);
        } else {
          const int t = i / RS, d = i - t * RS;
          d0[t * RS + d] = d < p.hd ? src[t * s_tok + d] : from_f<T>(0.f);
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a stage's K rows, then its V rows: two copy groups, so the scores can
// start while V is still in flight
template <typename T>
__device__ __forceinline__ void load_stage(const Params& p, T* kbuf, T* vbuf,
                                           const int* trow, int kh, int pg_lo,
                                           int n_pg, int chunks) {
  load_rows<T>(p, static_cast<const T*>(p.kp), p.k_sp, p.k_st, p.k_sh, kbuf,
               trow, kh, pg_lo, n_pg, chunks);
  load_rows<T>(p, static_cast<const T*>(p.vp), p.v_sp, p.v_st, p.v_sh, vbuf,
               trow, kh, pg_lo, n_pg, chunks);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// CH > 0: an instance for one query row a KV head (G = 1) and rows of CH
// 16-byte chunks, both constants, as at the serving shapes, so that every
// index split by chunks or row length is a shift or a multiply and the
// loops over query rows are gone; CH = 0 reads both at run time. MAXCI:
// P.V columns a lane (1 when G * chunks <= 32, as at the serving shapes:
// then 8 CTAs fit an SM by registers, and a whole grid of clusters is
// resident at once)
template <typename T, int CH, int MAXCI>
__global__ void __launch_bounds__(THREADS, MAXCI == 1 ? 8 : 1)
paged_split_kernel(const Params p) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = CH > 0 ? CH : p.chunks;
  const int G = CH > 0 ? 1 : p.G;
  const Layout L(p, VEC, chunks, G);
  float* fs = reinterpret_cast<float*>(smem_raw);
  float* qs = fs + L.qs;
  T* kv = reinterpret_cast<T*>(fs + L.n_f);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;            // == rank in the cluster
  const int n_split = gridDim.x;
  const int kh = blockIdx.y / p.R;
  const int g0 = (blockIdx.y - kh * p.R) * G;    // the tile's first row
  const int g_rows = min(G, p.G_all - g0);       // its rows that exist
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int RS = L.RS;
  const int len = p.lengths[b];
  const int* trow = p.table + b * p.t_sb;

  // this CTA's logical pages; with len > 0, positions from len on are
  // not summed (their weight would be exactly 0). The pages are loaded
  // whatever len is, so that the table and length reads overlap.
  const int pg0 = split * p.pps;
  const int pg_used = min(p.nblk, pg0 + p.pps) - pg0;
  const int tok_lim = len > 0 ? min((pg0 + pg_used) * p.page_sz, len)
                              : (pg0 + pg_used) * p.page_sz;
  const int n_stages = (pg_used + p.stage_pages - 1) / p.stage_pages;
  const int stage_elems = L.TS * RS;

  if (n_stages > 0)
    load_stage<T>(p, kv, kv + stage_elems, trow, kh, pg0,
                  min(p.stage_pages, pg_used), chunks);

  // q rows of this row tile in fp32, zero-padded to RS (rows past the
  // KV head's last are zeros)
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb +
                (kh * p.G_all + g0) * p.q_sh;
  for (int i = tid; i < G * RS; i += THREADS) {
    const int g = i / RS, d = i % RS;
    qs[i] = d < p.hd && g < g_rows ? to_f(qg[g * p.q_sh + d]) : 0.f;
  }
  float* wm = fs + L.wm + warp * G;
  float* wl = fs + L.wl + warp * G;
  float* wc = fs + L.wc + warp * G;
  float* sc = fs + L.sc + warp * G * L.TW;
  for (int g = lane; g < G; g += 32) {
    wm[g] = NEG_INF;
    wl[g] = 0.f;
  }

  // lane -> (token lane, column) of the P.V step
  const int n_cols = L.n_cols;
  const int TL = n_cols >= 32 ? 1 : 32 / n_cols;
  const int tl = n_cols >= 32 ? 0 : lane / n_cols;
  const int col0 = n_cols >= 32 ? lane : lane - tl * n_cols;
  const bool pv_on = tl < TL;
  float acc[MAXCI][VEC];
#pragma unroll
  for (int ci = 0; ci < MAXCI; ++ci)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[ci][j] = 0.f;

  const int lg = CH > 0 ? pow2_at_least(CH < 32 ? CH : 32) : p.lg;
  // scores in log2 units (scale * log2 e folded in): every exponential,
  // exp(x - m) = exp2(x log2 e - m log2 e), is one exp2f. A masked score
  // is -1e30 in either unit.
  const float scale2 = p.scale * 1.4426950408889634f;
  const int grp = lane / lg, li = lane % lg, n_grp = 32 / lg;

  for (int st = 0; st < n_stages; ++st) {
    const int buf = p.n_bufs == 2 ? (st & 1) : 0;
    T* kbuf = kv + buf * 2 * stage_elems;
    T* vbuf = kbuf + stage_elems;
    const bool more = st + 1 < n_stages;
    if (more) {
      T* nk = kv + ((st + 1) & 1) * 2 * stage_elems;
      const int lo = (st + 1) * p.stage_pages;
      load_stage<T>(p, nk, nk + stage_elems, trow, kh, pg0 + lo,
                    min(p.stage_pages, pg_used - lo), chunks);
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();                       // the stage's K (and q) landed

    const int t_lo = (pg0 + st * p.stage_pages) * p.page_sz;
    const int n_tok = min(min(p.stage_pages, pg_used - st * p.stage_pages)
                              * p.page_sz, tok_lim - t_lo);
    const int kw = n_tok > warp ? (n_tok - warp + WARPS - 1) / WARPS : 0;

    // scores of this warp's tokens w + 4k: lg lanes a row, fixed butterfly
    for (int k0 = 0; k0 < kw; k0 += n_grp) {
      const int k = k0 + grp;
      const bool on = k < kw;
      const T* krow = kbuf + (on ? warp + WARPS * k : 0) * RS;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        if (on) {
          for (int c = li; c < chunks; c += lg) {
            float kf[VEC], qf[VEC];
            Vec<T>::load(krow + c * VEC, kf);
            Vec<float>::load4(qs + g * RS + c * VEC, qf, VEC / 4);
#pragma unroll
            for (int j = 0; j < VEC; ++j) part = fmaf(qf[j], kf[j], part);
          }
        }
        for (int o = lg >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (on && li == 0)
          sc[g * L.TW + k] = len > 0 ? part * scale2 : NEG_INF;
      }
    }
    __syncwarp();

    // the warp's online-softmax statistics, one query row at a time
    for (int g = 0; g < G; ++g) {
      float mx = NEG_INF;
      for (int k = lane; k < kw; k += 32) mx = fmaxf(mx, sc[g * L.TW + k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = wm[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int k = lane; k < kw; k += 32) {
        const float e = exp2f(sc[g * L.TW + k] - m_new);
        sc[g * L.TW + k] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        wc[g] = corr;
        wl[g] = wl[g] * corr + sum;
        wm[g] = m_new;
      }
      __syncwarp();
    }

    if (more) cp_async_wait<2>();
    else cp_async_wait<0>();
    __syncthreads();                       // the stage's V landed

    // acc = acc * corr + sum_k p[k] v[k], k in order within the lane
#pragma unroll
    for (int ci = 0; ci < MAXCI; ++ci) {
      const int col = col0 + 32 * ci;
      if (!pv_on || col >= n_cols || (ci > 0 && n_cols < 32)) continue;
      const int g = col / chunks, c = col - g * chunks;
      const float corr = wc[g];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[ci][j] *= corr;
      const float* pg = sc + g * L.TW;
      for (int k = tl; k < kw; k += TL) {
        float vf[VEC];
        Vec<T>::load(vbuf + (warp + WARPS * k) * RS + c * VEC, vf);
        const float pk = pg[k];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[ci][j] = fmaf(pk, vf[j], acc[ci][j]);
      }
    }
    if (more) __syncthreads();             // buffers and sc are reused
  }

  // lane partials to shared memory, over the consumed K/V stages:
  // part[warp][tl * n_cols + col][VEC]
  __syncthreads();
  float* part = reinterpret_cast<float*>(kv);
#pragma unroll
  for (int ci = 0; ci < MAXCI; ++ci) {
    const int col = col0 + 32 * ci;
    if (!pv_on || col >= n_cols || (ci > 0 && n_cols < 32)) continue;
    float* dst = part + warp * L.part_w + (tl * n_cols + col) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = acc[ci][j];
  }
  __syncthreads();

  // the CTA's partial (m, l, acc), warps in order and each warp's lanes
  // in order, kept in its own shared memory
  for (int e = tid; e < G * RS; e += THREADS) {
    const int g = e / RS, d = e - g * RS;
    const int col = g * chunks + d / VEC, j = d % VEC;
    float M = NEG_INF;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, fs[L.wm + w * G + g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(fs[L.wm + w * G + g] - M);
      l = fmaf(fs[L.wl + w * G + g], wt, l);
      float s = 0.f;
      for (int t = 0; t < TL; ++t)
        s += part[w * L.part_w + (t * n_cols + col) * VEC + j];
      a = fmaf(s, wt, a);
    }
    fs[L.cacc + e] = a;
    if (d == 0) {
      fs[L.cm + g] = M;
      fs[L.cl + g] = l;
    }
  }
  // every CTA of the cluster is running and its partial is written; the
  // leader reads them through distributed shared memory and merges them
  // in split order, and the second barrier keeps every CTA (and so its
  // shared memory) alive until the leader has read it
  cluster.sync();
  if (cluster.block_rank() == 0) {
    T* out = static_cast<T*>(p.out) + b * p.o_sb +
             (kh * p.G_all + g0) * p.o_sh;
    for (int e = tid; e < G * RS; e += THREADS) {
      const int g = e / RS, d = e - g * RS;
      if (d >= p.hd || g >= g_rows) continue;
      float M = NEG_INF;
#pragma unroll
      for (int s = 0; s < MAX_SPLIT; ++s) {
        if (s >= n_split) break;
        M = fmaxf(M, *cluster.map_shared_rank(fs + L.cm + g, s));
      }
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int s = 0; s < MAX_SPLIT; ++s) {
        if (s >= n_split) break;
        const float wt =
            exp2f(*cluster.map_shared_rank(fs + L.cm + g, s) - M);
        l = fmaf(*cluster.map_shared_rank(fs + L.cl + g, s), wt, l);
        a = fmaf(*cluster.map_shared_rank(fs + L.cacc + e, s), wt, a);
      }
      out[g * p.o_sh + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();
}

// the decomposition, from shapes only: row tiles of the G_all rows, as
// many rows a tile as fit MAX_ROW_ELEMS, <= 8 splits of pps pages each,
// and stages of at most STAGE_BYTES of K+V; returns the number of splits
int plan(Params& p, int vec, size_t esz) {
  p.chunks = (p.hd + vec - 1) / vec;
  int g_max = MAX_ROW_ELEMS / (p.chunks * vec);
  if (PAGED_MAX_TILE_ROWS > 0 && PAGED_MAX_TILE_ROWS < g_max)
    g_max = PAGED_MAX_TILE_ROWS;
  p.R = (p.G_all + g_max - 1) / g_max;
  p.G = (p.G_all + p.R - 1) / p.R;
  p.lg = pow2_at_least(p.chunks < 32 ? p.chunks : 32);
  p.pps = (p.nblk + MAX_SPLIT - 1) / MAX_SPLIT;
  const size_t page_bytes = 2 * size_t(p.page_sz) * p.chunks * vec * esz;
  p.stage_pages = int(STAGE_BYTES / page_bytes);
  p.stage_pages = p.stage_pages < 1 ? 1
                  : (p.stage_pages > p.pps ? p.pps : p.stage_pages);
  p.n_bufs = p.stage_pages < p.pps ? 2 : 1;
  return (p.nblk + p.pps - 1) / p.pps;
}

size_t smem_bytes(const Params& p, int vec, size_t esz) {
  const Layout L(p, vec, p.chunks, p.G);
  return L.n_f * sizeof(float) + L.kv_bytes;
}

template <typename T>
using KernelFn = void (*)(const Params);

// the kernel instance for these shapes and its cluster launch config
template <typename T>
KernelFn<T> configure(Params& p, int B, int KH, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr, int& err) {
  constexpr int VEC = Vec<T>::N;
  const size_t esz = sizeof(T);
  const int n_split = plan(p, VEC, esz);
  err = int(cudaSuccess);
  if (p.G * p.chunks * VEC > MAX_ROW_ELEMS) err = int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p, VEC, esz);
  if (smem > 227 * 1024) err = int(cudaErrorInvalidValue);
  // G = 1 with rows of 8 or 10 chunks: hd 64 and 80 in bf16, the
  // serving shapes
  constexpr int WIDE = MAX_ROW_ELEMS / (32 * VEC);
  const bool one_row = p.G == 1;
  KernelFn<T> kernel = p.G * p.chunks > 32 ? paged_split_kernel<T, 0, WIDE>
                       : one_row && p.chunks == 8 ? paged_split_kernel<T, 8, 1>
                       : one_row && p.chunks == 10
                           ? paged_split_kernel<T, 10, 1>
                           : paged_split_kernel<T, 0, 1>;
  if (err == int(cudaSuccess))
    err = int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  cfg = {};
  cfg.gridDim = dim3(n_split, KH * p.R, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return kernel;
}

template <typename T>
int launch(Params p, int B, int H, int KH, void* stream) {
  constexpr int VEC = Vec<T>::N;
  const int hd = p.hd;
  if (B <= 0 || KH <= 0 || H % KH != 0 || hd <= 0 || p.page_sz <= 0 ||
      p.nblk <= 0 || hd > MAX_ROW_ELEMS)
    return int(cudaErrorInvalidValue);
  p.G_all = H / KH;
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(p.kp) |
                              reinterpret_cast<uintptr_t>(p.vp);
  const long long strides[] = {p.k_sp, p.k_st, p.k_sh,
                               p.v_sp, p.v_st, p.v_sh};
  bool aligned = hd % VEC == 0 && addr_bits % 16 == 0;
  for (long long s : strides) aligned = aligned && (s * sizeof(T)) % 16 == 0;
  p.aligned = aligned;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err;
  KernelFn<T> kernel = configure<T>(p, B, KH, cfg, attr, err);
  if (err != int(cudaSuccess)) return err;
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = int(cudaLaunchKernelEx(&cfg, kernel, p));
  if (err != int(cudaSuccess)) return err;
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
    Params p = {};                                                           \
    p.q = q; p.kp = kp; p.vp = vp;                                           \
    p.table = static_cast<const int*>(table);                                \
    p.lengths = static_cast<const int*>(lengths);                            \
    p.out = out; p.hd = hd; p.page_sz = page_sz; p.nblk = nblk;              \
    p.q_sb = q_sb; p.q_sh = q_sh; p.k_sp = k_sp; p.k_st = k_st;              \
    p.k_sh = k_sh; p.v_sp = v_sp; p.v_st = v_st; p.v_sh = v_sh;              \
    p.t_sb = t_sb; p.o_sb = o_sb; p.o_sh = o_sh; p.scale = scale;            \
    return launch<T>(p, B, H, KH, stream);                                   \
  }

PAGED_ENTRY(paged_attn_bf16, __nv_bfloat16)
PAGED_ENTRY(paged_attn_f32, float)

#undef PAGED_ENTRY

// the decomposition a call of these shapes launches, for reports: out =
// {n_split, pages per split, pages per stage, shared-memory bytes, the
// clusters of that launch the card can hold at once (a launch of
// B * KH * row_tiles clusters runs in one wave when this is at least
// that), row tiles a KV head, query rows a tile}
int paged_attn_plan(int nblk, int page_sz, int G, int hd, int bf16,
                    int* out) {
  Params p = {};
  p.G_all = G; p.hd = hd; p.page_sz = page_sz; p.nblk = nblk;
  if (G <= 0 || hd <= 0 || hd > MAX_ROW_ELEMS)
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err;
  if (bf16) {
    auto kernel = configure<__nv_bfloat16>(p, 1, 1, cfg, attr, err);
    if (err == 0) err = int(cudaOccupancyMaxActiveClusters(&out[4], kernel,
                                                           &cfg));
  } else {
    auto kernel = configure<float>(p, 1, 1, cfg, attr, err);
    if (err == 0) err = int(cudaOccupancyMaxActiveClusters(&out[4], kernel,
                                                           &cfg));
  }
  out[0] = int(cfg.gridDim.x);
  out[1] = p.pps;
  out[2] = p.stage_pages;
  out[3] = int(cfg.dynamicSmemBytes);
  out[5] = p.R;
  out[6] = p.G;
  return err;
}

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
