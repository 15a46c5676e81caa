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
// dtype code 0 = float32, 1 = bfloat16; all arithmetic is f32 in registers.
//
// Bound on the card: every kernel here does a handful of flops per element
// and is memory-bound (H100 SXM: 3.35 TB/s). Least times, bytes / 3.35 TB/s:
//   bn_stats      reads R*C*s                    (R=401408, C=256, bf16:
//                                                 205 MB -> ~61 us)
//   bn_apply      reads (1|2)*R*C*s, writes R*C*s
//   bn_bwd_stats  reads 3*R*C*s
//   bn_bwd_apply  reads 3*R*C*s, writes (1|2)*R*C*s
// (s = 2 for bf16, 4 for f32). What the design does about it: each thread
// moves 16 bytes per load along C (8 bf16 / 4 f32 channels) so a warp reads
// whole 128-byte lines; every input is read once and every output written
// once; the ReLU mask is re-derived from the saved output so no masked
// cotangent is ever stored.
//
// Reductions (bn_stats, bn_bwd_stats) are a split-R column reduction: the
// grid is (channel tiles) x (row chunks); each block walks its chunk with
// blockDim.y rows in flight, reduces across its rows in shared memory, and
// writes one (2, C) partial per chunk to a scratch buffer the wrapper
// allocates. A second tiny kernel sums the partials in a fixed order, so the
// result is deterministic (no float atomics). Rows >= R are never read: the
// last chunk's loop stops at R, which is the masking the TPU kernel does
// with _row_mask (including the product g*xhat in the backward).
//
// Elementwise kernels (bn_apply, bn_bwd_apply) are grid-stride loops over
// 16-byte packs with per-channel coefficients broadcast from a tiny (k, C)
// f32 table (cached in L1). Their arithmetic is written with explicit
// round-to-nearest intrinsics so that it rounds exactly as the plain
// PyTorch version does, operation by operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// Sum the per-row-slot accumulators of one block (shared memory laid out
// [2][blockDim.y][width]) and write this chunk's (2, C) partial.
__device__ __forceinline__ void block_partial_out(float* smem, int width,
                                                  int col0, int C,
                                                  float* partial_chunk) {
  __syncthreads();
  const int nthreads = blockDim.x * blockDim.y;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = t; k < 2 * width; k += nthreads) {
    const int s = k / width;
    const int w = k - s * width;
    const float* src = smem + s * blockDim.y * width + w;
    float acc = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) acc += src[y * width];
    const int c = col0 + w;
    if (c < C) partial_chunk[s * C + c] = acc;
  }
}

// Pass 1 of bn_stats: one (2, C) partial [sum x, sum x^2] per row chunk.
template <typename T, int VEC>
__global__ void bn_stats_partial(const T* __restrict__ x,
                                 float* __restrict__ partial, int64_t R,
                                 int C, int64_t rows_per_chunk) {
  extern __shared__ float smem[];
  const int width = blockDim.x * VEC;
  const int col0 = blockIdx.x * width;
  const int col = col0 + threadIdx.x * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (col < C) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const Pack<T, VEC> a = load_pack<T, VEC>(x + r * C + col);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f32(a.v[j]);
        s[j] += v;
        q[j] += v * v;
      }
    }
  }
  float* ss = smem + threadIdx.y * width + threadIdx.x * VEC;
  float* sq = ss + blockDim.y * width;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ss[j] = s[j];
    sq[j] = q[j];
  }
  block_partial_out(smem, width, col0, C,
                    partial + (int64_t)blockIdx.y * 2 * C);
}

// Pass 1 of bn_bwd_stats: partial [sum g, sum g*xhat] with g = dy where
// out > 0 else 0, xhat = (x - mean) * inv; coef is [mean; inv], (2, C).
template <typename T, int VEC>
__global__ void bn_bwd_stats_partial(const T* __restrict__ dy,
                                     const T* __restrict__ out,
                                     const T* __restrict__ x,
                                     const float* __restrict__ coef,
                                     float* __restrict__ partial, int64_t R,
                                     int C, int64_t rows_per_chunk) {
  extern __shared__ float smem[];
  const int width = blockDim.x * VEC;
  const int col0 = blockIdx.x * width;
  const int col = col0 + threadIdx.x * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  float sg[VEC], sgx[VEC], mean[VEC], inv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sg[j] = sgx[j] = 0.f;
    mean[j] = inv[j] = 0.f;
  }
  if (col < C) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = coef[col + j];
      inv[j] = coef[C + col + j];
    }
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const int64_t off = r * C + col;
      const Pack<T, VEC> d = load_pack<T, VEC>(dy + off);
      const Pack<T, VEC> o = load_pack<T, VEC>(out + off);
      const Pack<T, VEC> a = load_pack<T, VEC>(x + off);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float g = to_f32(o.v[j]) > 0.f ? to_f32(d.v[j]) : 0.f;
        const float xhat = (to_f32(a.v[j]) - mean[j]) * inv[j];
        sg[j] += g;
        sgx[j] += g * xhat;
      }
    }
  }
  float* ss = smem + threadIdx.y * width + threadIdx.x * VEC;
  float* sq = ss + blockDim.y * width;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ss[j] = sg[j];
    sq[j] = sgx[j];
  }
  block_partial_out(smem, width, col0, C,
                    partial + (int64_t)blockIdx.y * 2 * C);
}

// Pass 2 of both reductions: out[k] = sum over chunks of partial[chunk][k],
// k in [0, 2C), summed in a fixed order. Block (32, 32): 32 columns, each
// summed by 32 threads over a strided share of the chunks with four
// independent accumulators (loads in flight), then across the 32 in shared
// memory.
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int chunks, int C) {
  __shared__ float buf[32][33];
  const int k = blockIdx.x * 32 + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (k < 2 * C) {
    const int64_t step = (int64_t)2 * C;
    int ch = threadIdx.y;
    for (; ch + 96 < chunks; ch += 128) {
      a0 += partial[ch * step + k];
      a1 += partial[(ch + 32) * step + k];
      a2 += partial[(ch + 64) * step + k];
      a3 += partial[(ch + 96) * step + k];
    }
    for (; ch < chunks; ch += 32) a0 += partial[ch * step + k];
  }
  buf[threadIdx.y][threadIdx.x] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (threadIdx.y == 0 && k < 2 * C) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 32; ++y) t += buf[y][threadIdx.x];
    out[k] = t;
  }
}

// out = relu(x * coef[0] + coef[1] [+ res]) in x's dtype; coef is (2, C).
template <typename T, int VEC, bool RES>
__global__ void bn_apply(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ coef, T* __restrict__ out,
                         int64_t nvec, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int64_t e = i * VEC;
    const int c = (int)(e % C);
    const Pack<T, VEC> a = load_pack<T, VEC>(x + e);
    Pack<T, VEC> r;
    if (RES) r = load_pack<T, VEC>(res + e);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = __fadd_rn(__fmul_rn(to_f32(a.v[j]), __ldg(coef + c + j)),
                          __ldg(coef + C + c + j));
      if (RES) y = __fadd_rn(y, to_f32(r.v[j]));
      o.v[j] = from_f32<T>(relu(y));
    }
    store_pack<T, VEC>(out + e, o);
  }
}

// dx = coef[2] * (g - coef[3] - xhat * coef[4]) with g = dy where out > 0
// and xhat = (x - coef[0]) * coef[1]; coef is (5, C). With RES the same
// pass writes dres = g.
template <typename T, int VEC, bool RES>
__global__ void bn_bwd_apply(const T* __restrict__ dy,
                             const T* __restrict__ out,
                             const T* __restrict__ x,
                             const float* __restrict__ coef,
                             T* __restrict__ dx, T* __restrict__ dres,
                             int64_t nvec, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int64_t e = i * VEC;
    const int c = (int)(e % C);
    const Pack<T, VEC> d = load_pack<T, VEC>(dy + e);
    const Pack<T, VEC> o = load_pack<T, VEC>(out + e);
    const Pack<T, VEC> a = load_pack<T, VEC>(x + e);
    Pack<T, VEC> gx, gr;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int cj = c + j;
      const float g = to_f32(o.v[j]) > 0.f ? to_f32(d.v[j]) : 0.f;
      const float xhat = __fmul_rn(__fsub_rn(to_f32(a.v[j]), __ldg(coef + cj)),
                                   __ldg(coef + C + cj));
      const float t = __fsub_rn(__fsub_rn(g, __ldg(coef + 3 * C + cj)),
                                __fmul_rn(xhat, __ldg(coef + 4 * C + cj)));
      gx.v[j] = from_f32<T>(__fmul_rn(__ldg(coef + 2 * C + cj), t));
      if (RES) gr.v[j] = from_f32<T>(g);
    }
    store_pack<T, VEC>(dx + e, gx);
    if (RES) store_pack<T, VEC>(dres + e, gr);
  }
}

template <typename T, int VEC>
void launch_stats(const void* x, float* partial, float* sums, int64_t R,
                  int C, int tx, int ty, int chunks, int64_t rows_per_chunk,
                  cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  const size_t smem = 2 * (size_t)ty * width * sizeof(float);
  bn_stats_partial<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), partial, R, C, rows_per_chunk);
  sum_partials<<<(2 * C + 31) / 32, dim3(32, 32), 0, stream>>>(partial, sums,
                                                              chunks, C);
}

template <typename T, int VEC>
void launch_bwd_stats(const void* dy, const void* out, const void* x,
                      const float* coef, float* partial, float* sums,
                      int64_t R, int C, int tx, int ty, int chunks,
                      int64_t rows_per_chunk, cudaStream_t stream) {
  const int width = tx * VEC;
  dim3 grid((C + width - 1) / width, chunks);
  dim3 block(tx, ty);
  const size_t smem = 2 * (size_t)ty * width * sizeof(float);
  bn_bwd_stats_partial<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(out),
      static_cast<const T*>(x), coef, partial, R, C, rows_per_chunk);
  sum_partials<<<(2 * C + 31) / 32, dim3(32, 32), 0, stream>>>(partial, sums,
                                                              chunks, C);
}

template <typename T, int VEC>
void launch_apply(const void* x, const void* res, const float* coef,
                  void* out, int64_t R, int C, int blocks,
                  cudaStream_t stream) {
  const int64_t nvec = R * C / VEC;
  if (res != nullptr)
    bn_apply<T, VEC, true><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), coef,
        static_cast<T*>(out), nvec, C);
  else
    bn_apply<T, VEC, false><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(x), nullptr, coef, static_cast<T*>(out), nvec,
        C);
}

template <typename T, int VEC>
void launch_bwd_apply(const void* dy, const void* out, const void* x,
                      const float* coef, void* dx, void* dres, int64_t R,
                      int C, int blocks, cudaStream_t stream) {
  const int64_t nvec = R * C / VEC;
  if (dres != nullptr)
    bn_bwd_apply<T, VEC, true><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), coef, static_cast<T*>(dx),
        static_cast<T*>(dres), nvec, C);
  else
    bn_bwd_apply<T, VEC, false><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), coef, static_cast<T*>(dx), nullptr, nvec,
        C);
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
    } else {                                                    \
      return (int)cudaErrorInvalidValue;                        \
    }                                                           \
  } while (0)

extern "C" {

int mxt_bn_stats(const void* x, float* partial, float* sums, long long R,
                 int C, int dtype, int wide, int tx, int ty, int chunks,
                 long long rows_per_chunk, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_stats, x, partial, sums, R, C, tx, ty,
               chunks, rows_per_chunk, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_apply(const void* x, const void* res, const float* coef,
                 void* out, long long R, int C, int dtype, int wide,
                 int blocks, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_apply, x, res, coef, out, R, C, blocks,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_bwd_stats(const void* dy, const void* out, const void* x,
                     const float* coef, float* partial, float* sums,
                     long long R, int C, int dtype, int wide, int tx, int ty,
                     int chunks, long long rows_per_chunk, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_bwd_stats, dy, out, x, coef, partial,
               sums, R, C, tx, ty, chunks, rows_per_chunk,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mxt_bn_bwd_apply(const void* dy, const void* out, const void* x,
                     const float* coef, void* dx, void* dres, long long R,
                     int C, int dtype, int wide, int blocks, void* stream) {
  MXT_DISPATCH(dtype, wide, launch_bwd_apply, dy, out, x, coef, dx, dres, R,
               C, blocks, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
