// Fused training-mode BatchNorm(+residual add)+ReLU epilogue for Hopper
// (sm_90a): the four kernels of the ResNet bottleneck epilogue.
//
// Replaces the Pallas kernels of mxnet_tpu/ops/pallas_kernels.py:
//   mxt_bn_stats      <- _bn_stats_call      (per-channel [sum x, sum x^2])
//   mxt_bn_apply      <- _bn_apply_call      (relu(x*coef0 + coef1 [+ res]))
//   mxt_bn_bwd_stats  <- _bn_bwd_stats_call  ([sum g, sum g*xhat])
//   mxt_bn_bwd_apply  <- _bn_bwd_apply_call  (dx [, dres = g])
// The Python wrappers and their plain PyTorch versions live in
// mxnet_tpu_torch/ops/fused_bn_act.py.
//
// Layout: x is channel-last, flattened to (R, C) row-major, R = N*H*W.
// dtype code 0 = float32, 1 = bfloat16, 2 = float16; all arithmetic is f32
// in registers (a 16-bit input converts to f32 exactly; outputs round to
// nearest even, as PyTorch's casts do).
//
// Bound on the card: every kernel here does a handful of flops per element
// and is memory-bound (H100 SXM: 3.35 TB/s). Least times, bytes / 3.35 TB/s:
//   bn_stats      reads R*C*s                    (R=401408, C=256, bf16:
//                                                 205 MB -> ~61 us)
//   bn_apply      reads (1|2)*R*C*s, writes R*C*s
//   bn_bwd_stats  reads 3*R*C*s
//   bn_bwd_apply  reads 3*R*C*s, writes (1|2)*R*C*s
// (s = 2 for bf16 and f16, 4 for f32). What the design does about it: each
// thread moves 16 bytes per load along C (8 bf16 or f16 / 4 f32 channels) so
// a warp reads
// whole 128-byte lines; every input is read once and every output written
// once; the ReLU mask is re-derived from the saved output so no masked
// cotangent is ever stored.
//
// Reductions (bn_stats, bn_bwd_stats) are one launch each: a split-R
// column reduction that finishes itself. The grid is (channel tiles) x
// (row chunks). Thread (x, y) owns one pack of channels and walks rows
// r0 + y, r0 + y + blockDim.y, ... of its chunk UNROLL rows at a time
// (8 in bn_stats, 4 in bn_bwd_stats, which loads three tensors): all of a
// group's pack loads are issued before the first is used, and the rows left
// over go as one guarded group, so each thread keeps UNROLL loads in flight
// where a plain row loop keeps one. Sums stay in f32 registers. The block
// adds its blockDim.y row slots in order of y into its (2, width) tile in
// shared memory. Blocks of CLUSTER consecutive chunks form a thread-block
// cluster (Hopper): after a cluster barrier the first block adds the
// others' tiles in order of rank, reading their shared memory directly,
// and writes one partial per cluster. Then each cluster's first block
// takes a ticket (atomicAdd on an unsigned counter, after __threadfence),
// and the last to arrive for a column tile sums that tile's partials in
// cluster order; that sum splits its range of partials into blockDim.y
// contiguous pieces, one per row of threads, and adds the pieces in order.
// So the order of every addition is fixed by the grid alone: the result
// does not depend on which block arrives last, and no float atomics are
// used. The last arrival sets its counter back to 0, so the counters (an
// int32 workspace per stream, zeroed once by the wrapper) are left zeroed
// by every launch and need no memset per call. The cluster step cuts the
// partials that go through L2 and that the last block reads by CLUSTER;
// the serial tail after the last block's rows (cluster step, ticket, last
// sum) still costs about 4 us on the card, which is what a small site pays
// on top of its rows. Rows >= R are never read: the last chunk's walk
// stops at R (chunks past R, which fill the last cluster, read nothing),
// which is the masking the TPU kernel does with _row_mask (including the
// product g*xhat in the backward).
//
// bn_apply and bn_bwd_apply are row-tiled like the reductions: the grid is
// (channel tiles) x (row chunks), each thread owns one fixed pack of
// channels, loads that pack's (2 or 5, pack) coefficients into registers
// once and walks its chunk's rows APPLY_UNROLL at a time, every load of a
// group issued before the first is used, so there is no per-element table
// load and no index modulo, and each thread keeps APPLY_UNROLL rows of
// loads in flight (a flat grid-stride loop would pay a 64-bit `e % C` and
// 2 * VEC coefficient loads for every pack, with one pack in flight). The
// elementwise arithmetic is written with explicit round-to-nearest
// intrinsics so that it rounds exactly as the plain PyTorch version does,
// operation by operation.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements of T moved as one aligned load / store (16 bytes when wide).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// NaN-propagating ReLU, as torch.relu / jnp.maximum(y, 0).
__device__ __forceinline__ float relu(float y) { return y < 0.f ? 0.f : y; }

constexpr int STATS_UNROLL = 8;       // bn_stats: rows whose loads are in flight
constexpr int BWD_STATS_UNROLL = 4;   // bn_bwd_stats: three loads a row
constexpr int CLUSTER = 8;            // blocks along R that combine on chip

// Thread (x, y) holds sums a, b for its pack; add them over y = 0 ..
// blockDim.y - 1 in order (smem laid out [2][blockDim.y][width]) into the
// block's (2, width) column tile red[0 .. 2 * width).
template <int VEC>
__device__ __forceinline__ void block_sum(float* smem, const float (&a)[VEC],
                                          const float (&b)[VEC], float* red) {
  const int width = blockDim.x * VEC;
  float* sa = smem + threadIdx.y * width + threadIdx.x * VEC;
  float* sb = sa + blockDim.y * width;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sa[j] = a[j];
    sb[j] = b[j];
  }
  __syncthreads();
  const int nthreads = blockDim.x * blockDim.y;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = t; k < 2 * width; k += nthreads) {
    const int s = k / width;
    const float* src = smem + s * blockDim.y * width + (k - s * width);
    float acc = 0.f;
#pragma unroll 8
    for (int y = 0; y < (int)blockDim.y; ++y) acc += src[y * width];
    red[k] = acc;
  }
  __syncthreads();
}

// The tile red[0 .. 2 * width) into the block's columns of dst, (2, C).
template <int VEC>
__device__ __forceinline__ void store_tile(const float* red, int C,
                                           float* dst) {
  const int width = blockDim.x * VEC;
  const int col0 = blockIdx.x * width;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = t; k < 2 * width; k += blockDim.x * blockDim.y) {
    const int s = k / width;
    const int w = k - s * width;
    if (col0 + w < C) dst[s * C + col0 + w] = red[k];
  }
}

// VEC floats read through L2 (ld.global.cg), so that partials another
// block wrote in this launch are never served from a stale L1 line.
template <int VEC>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + j));
      v[j] = t.x;
      v[j + 1] = t.y;
      v[j + 2] = t.z;
      v[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __ldcg(p + j);
  }
}

// Sum n (2, C) partials src[0 .. n) over the block's column tile into
// dst: row y of threads adds entries [y * per, min(n, (y + 1) * per)),
// per = ceil(n / blockDim.y), in order, F of them loaded at a time, and
// block_sum adds the rows in order of y.
template <int VEC>
__device__ void sum_partials_block(float* smem, float* red, const float* src,
                                   int n, int C, float* dst) {
  constexpr int F = 32 / VEC;   // 64 floats in flight per thread
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int64_t pc = 2 * (int64_t)C;
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = b[j] = 0.f;
  if (col < C) {
    const int per = (n + blockDim.y - 1) / blockDim.y;
    int i = threadIdx.y * per;
    const int end = min(n, i + per);
    for (; i + F <= end; i += F) {
      float pa[F][VEC], pb[F][VEC];
#pragma unroll
      for (int u = 0; u < F; ++u) {
        load_cg<VEC>(src + (i + u) * pc + col, pa[u]);
        load_cg<VEC>(src + (i + u) * pc + C + col, pb[u]);
      }
#pragma unroll
      for (int u = 0; u < F; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a[j] += pa[u][j];
          b[j] += pb[u][j];
        }
    }
    for (; i < end; ++i) {
      float pa[VEC], pb[VEC];
      load_cg<VEC>(src + i * pc + col, pa);
      load_cg<VEC>(src + i * pc + C + col, pb);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        a[j] += pa[j];
        b[j] += pb[j];
      }
    }
  }
  block_sum<VEC>(smem, a, b, red);
  store_tile<VEC>(red, C, dst);
}

// The ticket of one block at a counter that n blocks reach in this launch:
// true in the last block to arrive, which sets the counter back to 0. The
// fence before the ticket makes this block's writes visible on the card
// before its ticket is counted; the fence after it orders the last block's
// reads of the others' writes after their tickets.
__device__ __forceinline__ bool last_arrival(unsigned* counter, int n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(counter, 1u) == (unsigned)(n - 1);
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// What every block of a reduction does after its rows. The block adds its
// row slots into its tile (shared memory). The CLUSTER blocks of a cluster
// (consecutive chunks of one column tile) meet at a cluster barrier, and
// the first of them adds the others' tiles in order of rank, read straight
// from their shared memory, and writes the cluster's partial; a second
// barrier keeps the others' shared memory alive until it has read them.
// Then the cluster leaders take tickets, and the last leader of the column
// tile sums the tile's cluster partials in order. partial is
// [clusters][2][C]; tickets has one counter per column tile. A single
// cluster writes sums directly.
template <int VEC>
__device__ void finish_reduction(float* smem, const float (&a)[VEC],
                                 const float (&b)[VEC], float* partial,
                                 float* sums, unsigned* tickets, int C) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int width = blockDim.x * VEC;
  float* red = smem + 2 * blockDim.y * width;
  block_sum<VEC>(smem, a, b, red);
  cluster.sync();
  const int clusters = gridDim.y / CLUSTER;
  const bool leader = cluster.block_rank() == 0;
  float* dst = clusters == 1
                   ? sums
                   : partial + (blockIdx.y / CLUSTER) * 2 * (int64_t)C;
  if (leader) {
    const float* peer[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) peer[q] = cluster.map_shared_rank(red, q);
    const int col0 = blockIdx.x * width;
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    for (int k = t; k < 2 * width; k += blockDim.x * blockDim.y) {
      float v[CLUSTER];
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) v[q] = peer[q][k];
      float acc = v[0];
#pragma unroll
      for (int q = 1; q < CLUSTER; ++q) acc += v[q];
      const int s = k / width;
      const int w = k - s * width;
      if (col0 + w < C) dst[s * C + col0 + w] = acc;
    }
  }
  cluster.sync();
  if (!leader || clusters == 1) return;
  if (!last_arrival(tickets + blockIdx.x, clusters)) return;
  sum_partials_block<VEC>(smem, red, partial, clusters, C, sums);
}

template <typename T, int VEC>
__device__ __forceinline__ void stats_add(const Pack<T, VEC>& a,
                                          float (&s)[VEC], float (&q)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = to_f32(a.v[j]);
    s[j] += v;
    q[j] += v * v;
  }
}

// bn_stats: sums = [sum x, sum x^2] over the rows, (2, C) f32. Thread
// (x, y) of block (bx, by) owns channels col .. col + VEC - 1, col = (bx *
// blockDim.x + x) * VEC, and rows r0 + y, r0 + y + blockDim.y, ... of the
// chunk [r0, r1), r0 = by * rows_per_chunk, STATS_UNROLL rows at a time.
template <typename T, int VEC>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(256, 2)
    bn_stats_reduce(const T* __restrict__ x, float* __restrict__ partial,
                    float* __restrict__ sums, unsigned* __restrict__ tickets,
                    int64_t R, int C, int64_t rows_per_chunk) {
  extern __shared__ float smem[];
  constexpr int U = STATS_UNROLL;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (col < C) {
    const int64_t step = blockDim.y;
    int64_t r = r0 + threadIdx.y;
    for (; r + (U - 1) * step < r1; r += U * step) {
      Pack<T, VEC> a[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        a[u] = load_pack<T, VEC>(x + (r + u * step) * C + col);
#pragma unroll
      for (int u = 0; u < U; ++u) stats_add<T, VEC>(a[u], s, q);
    }
    // the last rows (fewer than U), their loads also issued together
    Pack<T, VEC> a[U - 1];
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
      if (r + u * step < r1)
        a[u] = load_pack<T, VEC>(x + (r + u * step) * C + col);
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
      if (r + u * step < r1) stats_add<T, VEC>(a[u], s, q);
  }
  finish_reduction<VEC>(smem, s, q, partial, sums, tickets, C);
}

// g = dy where out > 0 else 0, xhat = (x - mean) * inv; adds g and g * xhat.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_stats_add(
    const Pack<T, VEC>& d, const Pack<T, VEC>& o, const Pack<T, VEC>& a,
    const float (&mean)[VEC], const float (&inv)[VEC], float (&sg)[VEC],
    float (&sgx)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float g = to_f32(o.v[j]) > 0.f ? to_f32(d.v[j]) : 0.f;
    const float xhat = (to_f32(a.v[j]) - mean[j]) * inv[j];
    sg[j] += g;
    sgx[j] += g * xhat;
  }
}

// bn_bwd_stats: sums = [sum g, sum g*xhat], coef = [mean; inv], (2, C);
// the same walk as bn_stats_reduce, BWD_STATS_UNROLL rows at a time.
template <typename T, int VEC>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(256, 2)
    bn_bwd_stats_reduce(const T* __restrict__ dy, const T* __restrict__ out,
                        const T* __restrict__ x,
                        const float* __restrict__ coef,
                        float* __restrict__ partial, float* __restrict__ sums,
                        unsigned* __restrict__ tickets, int64_t R, int C,
                        int64_t rows_per_chunk) {
  extern __shared__ float smem[];
  constexpr int U = BWD_STATS_UNROLL;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  float sg[VEC], sgx[VEC], mean[VEC], inv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sg[j] = sgx[j] = 0.f;
  if (col < C) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = coef[col + j];
      inv[j] = coef[C + col + j];
    }
    const int64_t step = blockDim.y;
    int64_t r = r0 + threadIdx.y;
    for (; r + (U - 1) * step < r1; r += U * step) {
      Pack<T, VEC> d[U], o[U], a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t off = (r + u * step) * C + col;
        d[u] = load_pack<T, VEC>(dy + off);
        o[u] = load_pack<T, VEC>(out + off);
        a[u] = load_pack<T, VEC>(x + off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        bwd_stats_add<T, VEC>(d[u], o[u], a[u], mean, inv, sg, sgx);
    }
    Pack<T, VEC> d[U - 1], o[U - 1], a[U - 1];
#pragma unroll
    for (int u = 0; u < U - 1; ++u) {
      const int64_t off = (r + u * step) * C + col;
      if (r + u * step < r1) {
        d[u] = load_pack<T, VEC>(dy + off);
        o[u] = load_pack<T, VEC>(out + off);
        a[u] = load_pack<T, VEC>(x + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
      if (r + u * step < r1)
        bwd_stats_add<T, VEC>(d[u], o[u], a[u], mean, inv, sg, sgx);
  }
  finish_reduction<VEC>(smem, sg, sgx, partial, sums, tickets, C);
}

// rows whose loads are in flight; a build switch for timing other depths
// (tools/kernel_variants_probe.py)
#ifndef MXT_APPLY_UNROLL
#define MXT_APPLY_UNROLL 4
#endif
constexpr int APPLY_UNROLL = MXT_APPLY_UNROLL;

// out = relu(x * k[0] + k[1] [+ res]) for one pack; k holds the pack's
// (2, VEC) coefficients.
template <typename T, int VEC, bool RES>
__device__ __forceinline__ void apply_pack(const Pack<T, VEC>& a,
                                           const Pack<T, VEC>& r,
                                           const float (&k)[2][VEC], T* out) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float y = __fadd_rn(__fmul_rn(to_f32(a.v[j]), k[0][j]), k[1][j]);
    if (RES) y = __fadd_rn(y, to_f32(r.v[j]));
    o.v[j] = from_f32<T>(relu(y));
  }
  store_pack<T, VEC>(out, o);
}

// The row-tiled pass of bn_apply: out = relu(x * coef[0] + coef[1] [+ res])
// in x's dtype, coef (2, C). Thread (x, y) of block (bx, by) owns channels
// col .. col + VEC - 1, col = (bx * blockDim.x + x) * VEC, and rows r0 + y,
// r0 + y + blockDim.y, ... of the chunk [r0, r1), r0 = by * rows_per_chunk,
// APPLY_UNROLL rows at a time: (1 or 2) * APPLY_UNROLL pack loads are issued
// before the first is used, and the rows left over go as one more guarded
// group.
template <typename T, int VEC, bool RES>
__global__ void bn_apply(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ coef, T* __restrict__ out,
                         int64_t R, int C, int64_t rows_per_chunk) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= C) return;
  float k[2][VEC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) k[i][j] = coef[i * C + col + j];
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  const int64_t step = blockDim.y;
  int64_t r = r0 + threadIdx.y;
  for (; r + (APPLY_UNROLL - 1) * step < r1; r += APPLY_UNROLL * step) {
    Pack<T, VEC> a[APPLY_UNROLL], b[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const int64_t off = (r + u * step) * C + col;
      a[u] = load_pack<T, VEC>(x + off);
      if (RES) b[u] = load_pack<T, VEC>(res + off);
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u)
      apply_pack<T, VEC, RES>(a[u], b[u], k, out + (r + u * step) * C + col);
  }
  // the last rows (fewer than APPLY_UNROLL), their loads also issued together
  constexpr int TAIL = APPLY_UNROLL - 1;
  Pack<T, VEC> a[TAIL], b[TAIL];
#pragma unroll
  for (int u = 0; u < TAIL; ++u) {
    const int64_t off = (r + u * step) * C + col;
    if (r + u * step < r1) {
      a[u] = load_pack<T, VEC>(x + off);
      if (RES) b[u] = load_pack<T, VEC>(res + off);
    }
  }
#pragma unroll
  for (int u = 0; u < TAIL; ++u)
    if (r + u * step < r1)
      apply_pack<T, VEC, RES>(a[u], b[u], k, out + (r + u * step) * C + col);
}

// dx = coef[2] * (g - coef[3] - xhat * coef[4]) for one pack, with g = dy
// where out > 0 and xhat = (x - coef[0]) * coef[1]; k holds the pack's
// (5, VEC) coefficients. With RES it also writes dres = g.
template <typename T, int VEC, bool RES>
__device__ __forceinline__ void bwd_apply_pack(const Pack<T, VEC>& d,
                                               const Pack<T, VEC>& o,
                                               const Pack<T, VEC>& a,
                                               const float (&k)[5][VEC],
                                               T* dx, T* dres) {
  Pack<T, VEC> gx, gr;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float g = to_f32(o.v[j]) > 0.f ? to_f32(d.v[j]) : 0.f;
    const float xhat = __fmul_rn(__fsub_rn(to_f32(a.v[j]), k[0][j]), k[1][j]);
    const float t = __fsub_rn(__fsub_rn(g, k[3][j]), __fmul_rn(xhat, k[4][j]));
    gx.v[j] = from_f32<T>(__fmul_rn(k[2][j], t));
    if (RES) gr.v[j] = from_f32<T>(g);
  }
  store_pack<T, VEC>(dx, gx);
  if (RES) store_pack<T, VEC>(dres, gr);
}

// The row-tiled pass of bn_bwd_apply; coef is (5, C). Thread (x, y) of
// block (bx, by) owns channels col .. col + VEC - 1, col = (bx * blockDim.x
// + x) * VEC, and rows r0 + y, r0 + y + blockDim.y, ... of the chunk
// [r0, r1), r0 = by * rows_per_chunk, UNROLL rows at a time: 3 * UNROLL
// pack loads are issued before the first is used, and the rows left over
// go as one more guarded group.
template <typename T, int VEC, bool RES>
__global__ void bn_bwd_apply(const T* __restrict__ dy,
                             const T* __restrict__ out,
                             const T* __restrict__ x,
                             const float* __restrict__ coef,
                             T* __restrict__ dx, T* __restrict__ dres,
                             int64_t R, int C, int64_t rows_per_chunk) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= C) return;
  float k[5][VEC];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) k[i][j] = coef[i * C + col + j];
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  const int64_t step = blockDim.y;
  int64_t r = r0 + threadIdx.y;
  for (; r + (APPLY_UNROLL - 1) * step < r1;
       r += APPLY_UNROLL * step) {
    Pack<T, VEC> d[APPLY_UNROLL], o[APPLY_UNROLL],
        a[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const int64_t off = (r + u * step) * C + col;
      d[u] = load_pack<T, VEC>(dy + off);
      o[u] = load_pack<T, VEC>(out + off);
      a[u] = load_pack<T, VEC>(x + off);
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const int64_t off = (r + u * step) * C + col;
      bwd_apply_pack<T, VEC, RES>(d[u], o[u], a[u], k, dx + off,
                                  RES ? dres + off : nullptr);
    }
  }
  // the last rows (fewer than UNROLL), their loads also issued together
  constexpr int TAIL = APPLY_UNROLL - 1;
  Pack<T, VEC> d[TAIL], o[TAIL], a[TAIL];
#pragma unroll
  for (int u = 0; u < TAIL; ++u) {
    const int64_t off = (r + u * step) * C + col;
    if (r + u * step < r1) {
      d[u] = load_pack<T, VEC>(dy + off);
      o[u] = load_pack<T, VEC>(out + off);
      a[u] = load_pack<T, VEC>(x + off);
    }
  }
#pragma unroll
  for (int u = 0; u < TAIL; ++u) {
    const int64_t off = (r + u * step) * C + col;
    if (r + u * step < r1)
      bwd_apply_pack<T, VEC, RES>(d[u], o[u], a[u], k, dx + off,
                                  RES ? dres + off : nullptr);
  }
}

template <typename T, int VEC>
void launch_stats(const void* x, float* partial, float* sums,
                  unsigned* tickets, int64_t R, int C, int tx, int ty,
                  int chunks, int64_t rows_per_chunk, cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  const size_t smem = 2 * (size_t)(ty + 1) * width * sizeof(float);
  bn_stats_reduce<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), partial, sums, tickets, R, C, rows_per_chunk);
}

template <typename T, int VEC>
void launch_bwd_stats(const void* dy, const void* out, const void* x,
                      const float* coef, float* partial, float* sums,
                      unsigned* tickets, int64_t R, int C, int tx, int ty,
                      int chunks, int64_t rows_per_chunk,
                      cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  const size_t smem = 2 * (size_t)(ty + 1) * width * sizeof(float);
  bn_bwd_stats_reduce<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(out),
      static_cast<const T*>(x), coef, partial, sums, tickets, R, C,
      rows_per_chunk);
}

template <typename T, int VEC>
void launch_apply(const void* x, const void* res, const float* coef,
                  void* out, int64_t R, int C, int tx, int ty, int chunks,
                  int64_t rows_per_chunk, cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  if (res != nullptr)
    bn_apply<T, VEC, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), coef,
        static_cast<T*>(out), R, C, rows_per_chunk);
  else
    bn_apply<T, VEC, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), nullptr, coef, static_cast<T*>(out), R, C,
        rows_per_chunk);
}

template <typename T, int VEC>
void launch_bwd_apply(const void* dy, const void* out, const void* x,
                      const float* coef, void* dx, void* dres, int64_t R,
                      int C, int tx, int ty, int chunks,
                      int64_t rows_per_chunk, cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  if (dres != nullptr)
    bn_bwd_apply<T, VEC, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), coef, static_cast<T*>(dx),
        static_cast<T*>(dres), R, C, rows_per_chunk);
  else
    bn_bwd_apply<T, VEC, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), coef, static_cast<T*>(dx), nullptr, R, C,
        rows_per_chunk);
}

}  // namespace

// Dispatch on (dtype, wide): wide packs are 16 bytes (the wrapper passes
// wide = 1 only when C is a multiple of the pack and every pointer is
// 16-byte aligned). Each entry point returns cudaGetLastError() after its
// launches; unknown dtype codes return cudaErrorInvalidValue.
#define MXT_DISPATCH(dtype, wide, FN, ...)                      \
  do {                                                          \
    if ((dtype) == 0) {                                         \
      if (wide) FN<float, 4>(__VA_ARGS__);                      \
      else FN<float, 1>(__VA_ARGS__);                           \
    } else if ((dtype) == 1) {                                  \
      if (wide) FN<__nv_bfloat16, 8>(__VA_ARGS__);              \
      else FN<__nv_bfloat16, 1>(__VA_ARGS__);                   \
    } else if ((dtype) == 2) {                                  \
      if (wide) FN<__half, 8>(__VA_ARGS__);                     \
      else FN<__half, 1>(__VA_ARGS__);                          \
    } else {                                                    \
      return (int)cudaErrorInvalidValue;                        \
    }                                                           \
  } while (0)

extern "C" {

int mxt_bn_stats(const void* x, float* partial, float* sums,
                 unsigned* tickets, long long R, int C, int dtype, int wide,
                 int tx, int ty, int chunks, long long rows_per_chunk,
                 void* stream) {
  MXT_DISPATCH(dtype, wide, launch_stats, x, partial, sums, tickets, R, C,
               tx, ty, chunks, rows_per_chunk, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_apply(const void* x, const void* res, const float* coef,
                 void* out, long long R, int C, int dtype, int wide, int tx,
                 int ty, int chunks, long long rows_per_chunk, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_apply, x, res, coef, out, R, C, tx, ty,
               chunks, rows_per_chunk, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_bwd_stats(const void* dy, const void* out, const void* x,
                     const float* coef, float* partial, float* sums,
                     unsigned* tickets, long long R, int C, int dtype,
                     int wide, int tx, int ty, int chunks,
                     long long rows_per_chunk, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_bwd_stats, dy, out, x, coef, partial,
               sums, tickets, R, C, tx, ty, chunks, rows_per_chunk,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_bwd_apply(const void* dy, const void* out, const void* x,
                     const float* coef, void* dx, void* dres, long long R,
                     int C, int dtype, int wide, int tx, int ty, int chunks,
                     long long rows_per_chunk, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_bwd_apply, dy, out, x, coef, dx, dres, R,
               C, tx, ty, chunks, rows_per_chunk, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
