// Flash-attention forward for Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, T, H, D) tensors, optional causal mask, f32 arithmetic.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/pallas_kernels.py:
//   mxt_flash_fwd  <- _build_flash (the pallas_call of flash_attention)
// The Python wrapper and its plain PyTorch version live in
// mxnet_tpu_torch/ops/flash_attention.py.
//
// What it computes is the TPU kernel's function, not its block structure.
// The TPU kernel holds all of K and V in VMEM for each 128-row query block
// and takes one full-row softmax. A Hopper block has at most 227 KB of
// shared memory, so here each block owns one (b, h, 64-row query tile) and
// streams K/V through shared memory in 64-row tiles with an online softmax
// held in f32 registers (running max m, running sum l, accumulator o);
// o / l is taken at the end and cast to the output dtype. Like the TPU
// kernel, q, k and v are upcast to f32 and p stays f32 for the PV product.
//
// Bound on the card: the work is 4*B*H*T^2*D flops (halved when causal)
// against 4*B*T*H*D*s bytes (s = 2 bf16, 4 f32): T/4 flops per byte when
// causal in bf16, 512 at T = 2048, above the ~300 at which an H100's bf16
// tensor cores stop waiting on memory. It is bound by operations. This
// kernel runs them as f32 FMAs outside the tensor cores (67 TFLOP/s, not
// 989), which is the first thing a later redesign with wgmma and bf16 p
// would change. What the design does within f32 FMAs: every K/V tile is
// loaded once per query tile and reused by 64 rows from shared memory; each
// thread computes a 4x4 block of scores and a 4 x (4*M) block of the output
// from 16-byte shared-memory reads (rows padded by 4 floats so the reads of
// 16 lanes fall in distinct banks); causal blocks skip the K tiles past
// their last row and the heaviest query tiles are scheduled first.
//
// Masking, as the reference does it: causal positions get -1e30, so once a
// row has seen a real score (column 0 is in the first tile of every row)
// their exp is exactly 0 in f32. Columns past T (ragged T) are -inf and rows
// past T are computed from zeros and not written. Any T >= 1 and D <= 256
// with D a multiple of 8.
//
// Layout: q, k, v and o are read and written through their (b, t, h)
// strides in elements, with the last dim contiguous, so the q/k/v views of
// a fused qkv projection go in without copies. No atomics, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key / value rows per tile
constexpr int NT = 256;       // threads: 16 (tx, columns) x 16 (ty, rows)
constexpr int LDP = BK + 4;   // padded row of the P tile

struct Strides {
  long long b, t, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int T, H, D, BH, nqt;
  float scale;
  int causal, vec;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 consecutive elements as f32: one 16-byte load for bf16, two for f32
// (vec: the pointer is 16-byte aligned), else element by element.
__device__ __forceinline__ void load8(const float* p, int vec, float* f) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = p[e];
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int vec,
                                      float* f) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = __bfloat1622float2(h2[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(p[e]);
  }
}

// Rows [row0, row0 + 64) of one (b, h) slice into a [64][ld] f32 tile;
// rows past T are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long st, int row0, int T_,
                                          int D, int ld, int vec) {
  const int chunks = D >> 3;
  for (int idx = threadIdx.x; idx < 64 * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) << 3;
    const int t = row0 + r;
    float f[8];
    if (t < T_) {
      load8(base + (long long)t * st + c, vec, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float* acc) {
  acc[0] = fmaf(p, v.x, acc[0]);
  acc[1] = fmaf(p, v.y, acc[1]);
  acc[2] = fmaf(p, v.z, acc[2]);
  acc[3] = fmaf(p, v.w, acc[3]);
}

// Max / sum over the 16 lanes (tx) that share a row group.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread (ty, tx) owns query rows ty*4 + i (i < 4), score columns
// tx + 16*j (j < 4) of each K tile, and output columns 4*(tx + 16*mm) .. +3
// (mm < M, M = DMAX / 64).
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int M = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D;
  const int ld = D + 4;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x % a.BH;
  const int qt = a.nqt - 1 - blockIdx.x / a.BH;   // heaviest tiles first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  load_tile<T>(Qs, qb, a.sq.t, q0, a.T, D, ld, a.vec);

  float o[4][M][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int mm = 0; mm < M; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][mm][e] = 0.f;
  }

  const int nkt = a.causal ? qt + 1 : (a.T + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile<T>(Ks, kb, a.sk.t, k0, a.T, D, ld, a.vec);
    load_tile<T>(Vs, vb, a.sv.t, k0, a.T, D, ld, a.vec);
    __syncthreads();

    // scores: s = (q . k) * scale, in f32
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile's columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.causal && kpos > qpos) x = -1e30f;
        if (kpos >= a.T) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int mm = 0; mm < M; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][mm][e] *= alpha;
    }
    __syncthreads();

    // o += p v
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LDP + c);
#pragma unroll
      for (int mm = 0; mm < M; ++mm) {
        const int col = 4 * (tx + 16 * mm);
        if (col < D) {
          const float4 v0 = *reinterpret_cast<const float4*>(Vs + c * ld + col);
          const float4 v1 =
              *reinterpret_cast<const float4*>(Vs + (c + 1) * ld + col);
          const float4 v2 =
              *reinterpret_cast<const float4*>(Vs + (c + 2) * ld + col);
          const float4 v3 =
              *reinterpret_cast<const float4*>(Vs + (c + 3) * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            axpy4(pv[i].x, v0, o[i][mm]);
            axpy4(pv[i].y, v1, o[i][mm]);
            axpy4(pv[i].z, v2, o[i][mm]);
            axpy4(pv[i].w, v3, o[i][mm]);
          }
        }
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.T) continue;
    T* row = ob + (long long)t * a.so.t;
#pragma unroll
    for (int mm = 0; mm < M; ++mm) {
      const int col = 4 * (tx + 16 * mm);
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store_out(row + col + e, o[i][mm][e] / l[i]);
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(3 * 64 * (D + 4) + BQ * LDP);
}

template <typename T, int DMAX>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.D);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.nqt * B * a.H;
  flash_fwd_kernel<T, DMAX><<<(unsigned)blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, t, h) of q, k, v and o in that order; the
// last dim of each is contiguous. dtype 0 = float32, 1 = bfloat16. vec = 1
// only when every pointer and every stride is 16-byte aligned. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  const long long* strides, int B, int T, int H, int D,
                  float scale, int causal, int dtype, int vec,
                  void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 8 || D > 256 || (D & 7) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.so = Strides{strides[9], strides[10], strides[11]};
  a.T = T;
  a.H = H;
  a.D = D;
  a.BH = B * H;
  a.nqt = (T + BQ - 1) / BQ;
  a.scale = scale;
  a.causal = causal;
  a.vec = vec;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(a, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
