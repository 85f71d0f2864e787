// AdamW for Hopper (sm_90a), hand-written CUDA C++: the gradient norm in
// one pass over the gradients, then the update of every parameter and both
// moments in one pass over p, g, m and v.
//
// Replaces: no TPU kernel. The JAX package computes AdamW in jnp
//           (src/repro/optim/adamw.py:56-62: the global norm, clipping, the
//           moments, the bias correction and the decayed update), which XLA
//           fuses; the port's plain version (kernels/adamw/ref.py) runs the
//           same arithmetic as about twenty fp32 elementwise kernels a leaf
//           and two more for the leaf's share of the norm, about 150 B of
//           device traffic a parameter.
//
// What bounds it on the card: bytes. The norm reads each gradient once (4 B
// an fp32 element); the update reads p, g, m and v and writes p, m and v
// (28 B an fp32 element; a bf16 p or g moves 2 B less for each). At the
// 2.84 B fp32 parameters of DeepSeek-V2-Lite's five-layer training
// configuration that is 91 GB a step, 27 ms at 3.35 TB/s. Nothing is read
// twice within a pass and the passes dwarf the 50 MB L2, so every load and
// store streams (__ldcs / __stcs).
//
// Design:
//   * a table of leaves (p, g, m, v pointers, element count, decay, whether
//     every pointer lies on a 16-B vector boundary, first chunk) is passed
//     by value as the kernel's parameter, MAX_LEAVES leaves a launch: one
//     launch covers every leaf of one (p dtype, g dtype) pair; more leaves
//     take more launches. A leaf is cut into chunks of CHUNK elements and
//     persistent CTAs stride over the table's chunks; a thread keeps UNROLL
//     16-B loads of each array in flight (4 fp32, or 4 bf16 in 8 B);
//   * a leaf whose pointers are not all on a vector boundary (a view at an
//     odd storage offset) takes scalar loads, and so do the at most three
//     elements that end a leaf whose size is no multiple of 4;
//   * the norm: a fixed grid of CTAs (the caller's count, whatever the
//     card) each sum the squares of their chunks, four elements in fp32 and
//     those in fp64, reduce in a fixed order and write one fp64 partial (or
//     add it to the partial a launch before wrote: one set of partials for
//     any number of tables); a finish launch of one CTA sums the partials
//     in a fixed order and writes, on the device, gnorm and scale = min(1,
//     clip / max(gnorm, 1e-9)). No atomics: two calls give the same bits.
//     On a mesh each rank writes the partials of its shards and the ranks
//     sum them elementwise before the finish, so a one-rank mesh gives the
//     bits of no mesh;
//   * the update reads scale, lr and the bias corrections bc1, bc2 from
//     device pointers (no host synchronisation) and takes each element
//     through the plain version's fp32 steps in the plain version's order,
//     with its fp32 constants, each rounded once (__fmul_rn, __fadd_rn,
//     __fdiv_rn, __fsqrt_rn: nvcc contracts nothing into an FMA). Given the
//     same scale, lr, bc1 and bc2 the result is the plain version's on the
//     card, bit for bit:
//       g' = g * scale
//       m  = m * b1 + (1 - b1) * g'
//       v  = v * b2 + (1 - b2) * (g' * g')
//       u  = (m / bc1) / (sqrt(v / bc2) + eps)
//       p  = p - lr * (u + decay * p)          (decay 0 below two dims)
//     a bf16 p is widened first and rounded to nearest even at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                              // elements a vector
constexpr int UNROLL = 4;                           // vectors a thread
constexpr int CHUNK = THREADS * VEC * UNROLL;       // elements a chunk
constexpr int MAX_LEAVES = 64;                      // a table: 3 KB
constexpr int FINISH_THREADS = 1024;

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;          // elements
  float decay;          // weight decay, 0 for leaves of fewer than 2 dims
  int vec;              // every pointer on a 16-B (bf16: 8-B) boundary
  long long chunk0;     // the leaf's first chunk in the table
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
  long long chunks;
};

struct Update {
  const float* scale;
  const float* lr;
  const float* bc1;
  const float* bc2;
  float b1, omb1, b2, omb2, eps;   // b1, 1 - b1, b2, 1 - b2, eps in fp32
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* a, long long i, float x) {
  __stcs(a + i, x);
}
__device__ __forceinline__ void from_f(__nv_bfloat16* a, long long i,
                                       float x) {
  a[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ld1(const float* a, long long i) {
  return __ldcs(a + i);
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* a, long long i) {
  return to_f(a[i]);
}

// four elements from vector i (16 B of fp32, 8 B of bf16)
__device__ __forceinline__ void ld4(const float* a, long long i,
                                    float (&x)[VEC]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(a) + i);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* a, long long i,
                                    float (&x)[VEC]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(a) + i);
  x[0] = __uint_as_float(q.x << 16);
  x[1] = __uint_as_float(q.x & 0xffff0000u);
  x[2] = __uint_as_float(q.y << 16);
  x[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* a, long long i,
                                    const float (&x)[VEC]) {
  __stcs(reinterpret_cast<float4*>(a) + i, make_float4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st4(__nv_bfloat16* a, long long i,
                                    const float (&x)[VEC]) {
  uint2 q;
  q.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  q.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  __stcs(reinterpret_cast<uint2*>(a) + i, q);
}

struct Scalars {
  float scale, lr, bc1, bc2, b1, omb1, b2, omb2, eps, decay;
};

// one element, the plain version's steps in its order
__device__ __forceinline__ void adamw_step(float& p, float g, float& m,
                                           float& v, const Scalars& s) {
  const float gs = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, gs));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(s.omb2, __fmul_rn(gs, gs)));
  const float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  p = __fsub_rn(p, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(s.decay, p))));
}

// the table's leaf of chunk c, walking up from leaf i (a CTA's chunks only
// grow)
__device__ __forceinline__ int leaf_of(const Table& t, long long c, int i) {
  while (i + 1 < t.count && c >= t.leaf[i + 1].chunk0) ++i;
  return i;
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS, 2)
    adamw_update_kernel(const Table t, const Update u) {
  Scalars s;
  s.scale = *u.scale;
  s.lr = *u.lr;
  s.bc1 = *u.bc1;
  s.bc2 = *u.bc2;
  s.b1 = u.b1;
  s.omb1 = u.omb1;
  s.b2 = u.b2;
  s.omb2 = u.omb2;
  s.eps = u.eps;
  int li = 0;
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    li = leaf_of(t, c, li);
    P* const pp = static_cast<P*>(t.leaf[li].p);
    const G* const gp = static_cast<const G*>(t.leaf[li].g);
    float* const mp = t.leaf[li].m;
    float* const vp = t.leaf[li].v;
    const long long n = t.leaf[li].n;
    s.decay = t.leaf[li].decay;
    const long long start = (c - t.leaf[li].chunk0) * CHUNK;
    const long long len = n - start < CHUNK ? n - start : CHUNK;
    if (t.leaf[li].vec) {
      const long long v0 = start / VEC, nv = len / VEC;
      float p[UNROLL][VEC], g[UNROLL][VEC], m[UNROLL][VEC], v[UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = threadIdx.x + k * THREADS;
        if (j < nv) {
          ld4(pp, v0 + j, p[k]);
          ld4(gp, v0 + j, g[k]);
          ld4(mp, v0 + j, m[k]);
          ld4(vp, v0 + j, v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = threadIdx.x + k * THREADS;
        if (j < nv) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            adamw_step(p[k][e], g[k][e], m[k][e], v[k][e], s);
          st4(pp, v0 + j, p[k]);
          st4(mp, v0 + j, m[k]);
          st4(vp, v0 + j, v[k]);
        }
      }
      // the leaf's last one to three elements
      const long long e = start + nv * VEC + threadIdx.x;
      if (threadIdx.x < len - nv * VEC) {
        float pe = to_f(pp[e]), me = mp[e], ve = vp[e];
        adamw_step(pe, ld1(gp, e), me, ve, s);
        from_f(pp, e, pe);
        mp[e] = me;
        vp[e] = ve;
      }
    } else {
      for (long long j = threadIdx.x; j < len; j += THREADS) {
        const long long e = start + j;
        float pe = to_f(pp[e]), me = mp[e], ve = vp[e];
        adamw_step(pe, ld1(gp, e), me, ve, s);
        from_f(pp, e, pe);
        mp[e] = me;
        vp[e] = ve;
      }
    }
  }
}

// a fixed-order sum over the CTA: warp shuffles, then warp 0 over the warps
template <int NT>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sum[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sum[w] = x;
  __syncthreads();
  x = lane < NT / 32 ? warp_sum[lane] : 0.0;
  if (w == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
    adamw_sumsq_kernel(const Table t, double* partial, int accumulate) {
  double acc = 0.0;
  int li = 0;
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    li = leaf_of(t, c, li);
    const G* const gp = static_cast<const G*>(t.leaf[li].g);
    const long long n = t.leaf[li].n;
    const long long start = (c - t.leaf[li].chunk0) * CHUNK;
    const long long len = n - start < CHUNK ? n - start : CHUNK;
    long long done = 0;
    if (t.leaf[li].vec) {
      const long long v0 = start / VEC, nv = len / VEC;
      float g[UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = threadIdx.x + k * THREADS;
        if (j < nv) ld4(gp, v0 + j, g[k]);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = threadIdx.x + k * THREADS;
        if (j < nv) {
          float q = __fmul_rn(g[k][0], g[k][0]);
#pragma unroll
          for (int e = 1; e < VEC; ++e) q = __fmaf_rn(g[k][e], g[k][e], q);
          acc += double(q);
        }
      }
      done = nv * VEC;
    }
    for (long long j = done + threadIdx.x; j < len; j += THREADS) {
      const double x = ld1(gp, start + j);
      acc += x * x;
    }
  }
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0)
    partial[blockIdx.x] = accumulate ? partial[blockIdx.x] + acc : acc;
}

__global__ void __launch_bounds__(FINISH_THREADS)
    adamw_finish_kernel(const double* partial, int n, float clip,
                        float* gnorm, float* scale) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partial[i];
  acc = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) {
    const float gn = float(sqrt(acc));
    // clamp(clip / clamp(gn, min=1e-9), max=1) as torch computes it:
    // reciprocal(clamp(gn)) * clip, NaN kept
    const float c = gn < 1e-9f ? 1e-9f : gn;
    const float r = __fmul_rn(__fdiv_rn(1.0f, c), clip);
    *gnorm = gn;
    *scale = r > 1.0f ? 1.0f : r;
  }
}

bool aligned(const void* a, int bytes) {
  return (reinterpret_cast<uintptr_t>(a) % bytes) == 0;
}

// fills t with leaves [first, first + count) of the call's arrays; returns
// false on an argument the kernels do not take
bool fill(Table& t, const long long* ptrs, int stride, const long long* numel,
          const float* decay, int first, int count, int p_bytes,
          int g_bytes) {
  t.count = count;
  t.chunks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* q = ptrs + (long long)(first + i) * stride;
    Leaf& l = t.leaf[i];
    l.n = numel[first + i];
    if (l.n < 0) return false;
    if (stride == 4) {
      l.p = reinterpret_cast<void*>(q[0]);
      l.g = reinterpret_cast<const void*>(q[1]);
      l.m = reinterpret_cast<float*>(q[2]);
      l.v = reinterpret_cast<float*>(q[3]);
      l.decay = decay[first + i];
      l.vec = aligned(l.p, VEC * p_bytes) && aligned(l.g, VEC * g_bytes) &&
              aligned(l.m, 16) && aligned(l.v, 16);
    } else {
      l.p = nullptr;
      l.g = reinterpret_cast<const void*>(q[0]);
      l.m = l.v = nullptr;
      l.decay = 0.0f;
      l.vec = aligned(l.g, VEC * g_bytes);
    }
    l.chunk0 = t.chunks;
    t.chunks += (l.n + CHUNK - 1) / CHUNK;
  }
  return true;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename P, typename G>
int update_grid() {
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adamw_update_kernel<P, G>, THREADS, 0) != cudaSuccess)
    per_sm = 1;
  return sm_count() * (per_sm > 0 ? per_sm : 1);
}

template <typename P, typename G>
int update_launches(const long long* ptrs, const long long* numel,
                    const float* decay, int n_leaves, const Update& u,
                    cudaStream_t s) {
  Table t;
  for (int first = 0; first < n_leaves; first += MAX_LEAVES) {
    const int count =
        n_leaves - first < MAX_LEAVES ? n_leaves - first : MAX_LEAVES;
    if (!fill(t, ptrs, 4, numel, decay, first, count, sizeof(P), sizeof(G)))
      return int(cudaErrorInvalidValue);
    long long grid = update_grid<P, G>();
    if (t.chunks < grid) grid = t.chunks > 0 ? t.chunks : 1;
    adamw_update_kernel<P, G><<<unsigned(grid), THREADS, 0, s>>>(t, u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

template <typename G>
int sumsq_launches(const long long* g_ptrs, const long long* numel,
                   int n_leaves, double* partial, int blocks, int accumulate,
                   cudaStream_t s) {
  Table t;
  for (int first = 0; first < n_leaves; first += MAX_LEAVES) {
    const int count =
        n_leaves - first < MAX_LEAVES ? n_leaves - first : MAX_LEAVES;
    if (!fill(t, g_ptrs, 1, numel, nullptr, first, count, 0, sizeof(G)))
      return int(cudaErrorInvalidValue);
    adamw_sumsq_kernel<G><<<blocks, THREADS, 0, s>>>(
        t, partial, accumulate || first > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// leaves a launch
int adamw_table_leaves() { return MAX_LEAVES; }

// The norm's partials: ceil(n_leaves / MAX_LEAVES) launches of `blocks`
// CTAs over the gradients g_ptrs[i] of numel[i] elements (fp32, or bf16
// when g_bf16), each adding its `blocks` fp64 partials to partial's; the
// first writes them instead unless `accumulate`.
int adamw_sumsq(const long long* g_ptrs, const long long* numel, int n_leaves,
                int g_bf16, void* partial, int blocks, int accumulate,
                void* stream) {
  if (n_leaves < 0 || blocks <= 0 || (n_leaves > 0 && partial == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* out = static_cast<double*>(partial);
  return g_bf16 ? sumsq_launches<__nv_bfloat16>(g_ptrs, numel, n_leaves, out,
                                                blocks, accumulate, s)
                : sumsq_launches<float>(g_ptrs, numel, n_leaves, out, blocks,
                                        accumulate, s);
}

// One launch: gnorm = sqrt(sum of the n partials), scale = min(1, clip /
// max(gnorm, 1e-9)), both fp32 on the device.
int adamw_sumsq_finish(const void* partial, int n, float clip, void* gnorm,
                       void* scale, void* stream) {
  if (n < 0 || gnorm == nullptr || scale == nullptr)
    return int(cudaErrorInvalidValue);
  adamw_finish_kernel<<<1, FINISH_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), n, clip,
      static_cast<float*>(gnorm), static_cast<float*>(scale));
  return int(cudaGetLastError());
}

// ceil(n_leaves / MAX_LEAVES) launches: leaf i's p, g, m, v are
// ptrs[4 i .. 4 i + 3], numel[i] elements, decay[i] its weight decay; p
// and g fp32, or bf16 when p_bf16 / g_bf16; m and v fp32. scale, lr, bc1,
// bc2 point to fp32 scalars on the device; b1 .. eps are the plain
// version's fp32 constants.
int adamw_update(const long long* ptrs, const long long* numel,
                 const float* decay, int n_leaves, int p_bf16, int g_bf16,
                 const void* scale, const void* lr, const void* bc1,
                 const void* bc2, float b1, float omb1, float b2, float omb2,
                 float eps, void* stream) {
  if (n_leaves < 0 || scale == nullptr || lr == nullptr || bc1 == nullptr ||
      bc2 == nullptr)
    return int(cudaErrorInvalidValue);
  Update u;
  u.scale = static_cast<const float*>(scale);
  u.lr = static_cast<const float*>(lr);
  u.bc1 = static_cast<const float*>(bc1);
  u.bc2 = static_cast<const float*>(bc2);
  u.b1 = b1;
  u.omb1 = omb1;
  u.b2 = b2;
  u.omb2 = omb2;
  u.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (p_bf16 && g_bf16)
    return update_launches<bf, bf>(ptrs, numel, decay, n_leaves, u, s);
  if (p_bf16)
    return update_launches<bf, float>(ptrs, numel, decay, n_leaves, u, s);
  if (g_bf16)
    return update_launches<float, bf>(ptrs, numel, decay, n_leaves, u, s);
  return update_launches<float, float>(ptrs, numel, decay, n_leaves, u, s);
}

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
