// Flash-attention forward for Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, T, H, D) tensors, optional causal mask.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/pallas_kernels.py:
//   mxt_flash_fwd     <- _build_flash (the pallas_call of flash_attention)
//   mxt_flash_fwd_tc  <- the same, for bf16 with D 64 or 128 (see below)
// The Python wrapper, its route rule and the plain PyTorch version live in
// mxnet_tpu_torch/ops/flash_attention.py. Two kernels, chosen by shape:
//
// flash_fwd_tc_kernel (mxt_flash_fwd_tc): bf16, D in {64, 128}, pointers
// and (b, t, h) strides 16-byte aligned. The two products run on the
// tensor cores with wgmma; TMA brings the tiles in. Bound on the card: the
// work is 4*B*H*T^2*D flops (halved when causal) against 4*B*T*H*D*2 bytes,
// T/4 flops per byte when causal, 512 at T = 2048, above the ~295 at which
// the H100's bf16 tensor cores (989 TFLOP/s) stop waiting on memory: it is
// bound by operations. The design, per block of 384 threads:
//   - a block owns one (b, h) and 128 query rows, two consumer warpgroups
//     of 64 rows each; the heaviest query tiles are scheduled first;
//   - a producer warpgroup (one thread issues; setmaxnreg hands its
//     registers to the consumers, 40 against 232) makes TMA loads of the Q
//     tile and of 128-row K and V tiles into a ring of 2 stages, signalled
//     by mbarriers, through one 4-D tensor map per operand over (D, H, T,
//     B) with the views' strides (so the q/k/v views of a fused qkv
//     projection go in without a copy); rows past T arrive as zeros (TMA's
//     out-of-bounds fill). Tiles are 128-byte swizzled: a 64-column box is
//     one 128-byte row per key. K and V stages are released separately;
//   - S = Q K^T with wgmma.m64n128k16, both operands in shared memory
//     (K-major), f32 accumulators;
//   - the online softmax in f32 registers on the accumulator fragments
//     (row max over the 4 lanes that share a row, running m and l, O
//     rescaled), in base 2 with the scale folded into log2(e);
//   - O += P V with wgmma.m64n64k16 per 64 columns of D: P converted to
//     bf16 in registers is the A operand (the accumulator layout of S is
//     the A-fragment layout, 16 keys at a time); V is the B operand from
//     shared memory, MN-major (the descriptor's transpose bit);
//   - each warpgroup issues S of tile kt and P V of tile kt - 1 together
//     and takes the softmax of tile kt while the second product runs; the
//     two warpgroups take turns to issue (named barriers), so one's
//     softmax overlaps the other's products. At D 64 the exponentials
//     (16 a clock per SM) take as long per tile as the tensor cores;
//   - O / l rounded to bf16 and stored through the output's strides.
// Causal blocks stop at the diagonal tile; only the diagonal tile and a
// ragged last tile are masked. Tolerance against the f32 plain version:
// Q K^T of bf16 inputs is exact in f32 and P is the only new rounding: P in
// bf16 has a relative error of at most 2^-8 per element, so the output
// moves by at most 2^-8 * max|v| before its own rounding to bf16. An
// element passes when |got - want| <= 2e-5 + 2^-7 |want| + 2^-8 max|v|.
//
// flash_fwd_kernel (mxt_flash_fwd): every other call (f32, other D,
// unaligned views), f32 arithmetic, the plain version's tolerance.
// What it computes is the TPU kernel's function, not its block structure.
// The TPU kernel holds all of K and V in VMEM for each 128-row query block
// and takes one full-row softmax. A Hopper block has at most 227 KB of
// shared memory, so here each block owns one (b, h, 64-row query tile) and
// streams K/V through shared memory in 64-row tiles with an online softmax
// held in f32 registers (running max m, running sum l, accumulator o);
// o / l is taken at the end and cast to the output dtype. Like the TPU
// kernel, q, k and v are upcast to f32 and p stays f32 for the PV product.
//
// It runs the products as f32 FMAs outside the tensor cores (67 TFLOP/s,
// not 989), exact in f32 for f32 inputs. What the design does within f32
// FMAs: every K/V tile is
// loaded once per query tile and reused by 64 rows from shared memory; each
// thread computes a 4x4 block of scores and a 4 x (4*M) block of the output
// from 16-byte shared-memory reads (rows padded by 4 floats so the reads of
// 16 lanes fall in distinct banks); causal blocks skip the K tiles past
// their last row and the heaviest query tiles are scheduled first.
//
// Masking, as the reference does it, in both kernels: causal positions get
// -1e30, so once a row has seen a real score (column 0 is in the first tile
// of every row) their exp is exactly 0 in f32. Columns past T (ragged T)
// are -inf and rows past T are computed from zeros and not written. The
// SIMT kernel takes any T >= 1 and D <= 256 with D a multiple of 8.
//
// Layout: q, k, v and o are read and written through their (b, t, h)
// strides in elements, with the last dim contiguous, so the q/k/v views of
// a fused qkv projection go in without copies. No atomics, no allocation.

#include <cuda.h>   // CUtensorMap, cuTensorMapEncodeTiled (linked -lcuda)
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

// ---------------------------------------------------------------------------
// flash_fwd_tc_kernel: the tensor-core route (bf16, D 64 or 128)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;          // query rows per block (2 x 64)
constexpr int TC_BN = 128;          // key / value rows per tile
constexpr int TC_STAGES = 2;        // K/V ring
constexpr int TC_THREADS = 384;     // warpgroups 0-1 consume, 2 loads
constexpr int TC_CONSUMERS = 256;
constexpr int TC_PRODUCER_REGS = 40;    // setmaxnreg: the loader gives up
constexpr int TC_CONSUMER_REGS = 232;   // registers to the consumers
constexpr int TC_BOX = TC_BN * 128; // one 64-column box: 128 rows x 128 B

struct TcArgs {
  __nv_bfloat16* o;
  long long so_b, so_t, so_h;
  int T, H, BH, nqt, causal;
  float scale_log2;   // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A wait
// that lasts some 10^10 cycles (seconds) traps, so a fault in the
// pipeline's bookkeeping ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 4-D TMA box (64 columns of D, 1 head, 128 rows of T, 1 batch) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(t0), "r"(b) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte aligned
// memory): start address, leading and stride byte offsets in 16-byte
// units, layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (Q as A, K as B): 128-byte rows along D, 8-row groups
// 1024 bytes apart; the leading offset is unused under this swizzle.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major operand (V as B): 64 columns of D per 128-byte row, 8-key groups
// 1024 bytes apart; one swizzle atom spans the product's 64 columns.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return smem_desc(addr, TC_BOX, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Orders register uses after an asynchronous wgmma: later reads (and
// writes) of these registers depend on this point, after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MXT_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64 x 16] B[16 x 128]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MXT_F8(d, 0), MXT_F8(d, 8), MXT_F8(d, 16), MXT_F8(d, 24),
        MXT_F8(d, 32), MXT_F8(d, 40), MXT_F8(d, 48), MXT_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64 x 16] B[16 x 64], A (bf16 pairs) in registers, B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : MXT_F8(d, 0), MXT_F8(d, 8), MXT_F8(d, 16), MXT_F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef MXT_F8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup holds
// rows 16*(t/32) + (t%32)/4 + 8*i (i < 2) and columns 8*j + 2*(t%4) + c
// (c < 2) in register j*4 + i*2 + c. NB = D / 64 boxes per tile.

// S = Q K^T of one tile, 16 columns of D per wgmma (32 bytes into each
// 128-byte row); issued, not committed.
template <int NB>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qa,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint32_t off = (kk >> 2) * TC_BOX + (kk & 3) * 32;
    wgmma_qk(s, desc_kmajor(qa + off), desc_kmajor(ks + off), kk > 0);
  }
}

// O += P V of one tile: keys 16*kk .. +15 are the A-fragment registers
// p[4kk .. 4kk+3], 64 columns of D per wgmma; issued, not committed.
template <int NB>
__device__ __forceinline__ void issue_pv(float (&o)[NB][32],
                                         const uint32_t (&p)[32],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < TC_BN / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_pv(o[nb], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               desc_mnmajor(vs + nb * TC_BOX + kk * 2048));
}

// The online softmax of one tile's scores, base 2 (x = s * scale *
// log2(e)): updates the running max m and this thread's share of the row
// sums l, writes P as bf16 pairs in A-fragment order and the factor alpha
// by which the accumulator of the earlier tiles must be rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[64],
                                             uint32_t (&p)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const TcArgs& a, int k0,
                                             bool masked, int row0, int cq) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[j * 4 + i * 2 + c] * a.scale_log2;
        if (masked) {
          const int col = k0 + 8 * j + cq + c;
          if (a.causal && col > row0 + 8 * i) x = -1e30f;
          if (col >= a.T) x = -INFINITY;
        }
        s[j * 4 + i * 2 + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
  float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    base[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    alpha[i] = fast_exp2(m[i] - base[i]);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = fast_exp2(s[j * 4 + i * 2] - base[i]);
      const float p1 = fast_exp2(s[j * 4 + i * 2 + 1] - base[i]);
      rs[i] += p0 + p1;
      p[j * 2 + i] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' issue of
// products (ping-pong): warpgroup w waits on barrier 1 + w before it issues
// and lets the other one go after, so one warpgroup's softmax runs while
// the other's products occupy the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(TC_CONSUMERS)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(TC_CONSUMERS)
               : "memory");
}

// Pipeline of one consumer warpgroup, tile kt >= 1: issue S_kt = Q K_kt^T
// and O += P_{kt-1} V_{kt-1}, then take the softmax of S_kt while the
// tensor cores run the second product; rescale O once it is done. K and V
// stages are released separately (K after its product, V after its own).
// The two consumer warpgroups take turns to issue (turn_wait/turn_pass):
// nkt + 1 issues each, warpgroup 0 first.
template <int NB>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const TcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NB * TC_BOX;   // stage st at + st * NB * TC_BOX
  const uint32_t v_s = k_s + TC_STAGES * NB * TC_BOX;
  const uint32_t bars = v_s + TC_STAGES * NB * TC_BOX;
  const uint32_t q_full = bars;             // then 8 bytes per stage each:
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = k_full + 8 * TC_STAGES;
  const uint32_t k_empty = v_full + 8 * TC_STAGES;
  const uint32_t v_empty = k_empty + 8 * TC_STAGES;

  const int bh = blockIdx.x % a.BH;
  const int qt = a.nqt - 1 - blockIdx.x / a.BH;   // heaviest tiles first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * TC_BM;
  const int nkt = a.causal ? qt + 1 : (a.T + TC_BN - 1) / TC_BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, TC_CONSUMERS);
      mbar_init(v_empty + 8 * st, TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= TC_CONSUMERS / 32) {
    // producer warpgroup: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        TC_PRODUCER_REGS));
    if (warp == TC_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(q_full, NB * TC_BOX);
      for (int nb = 0; nb < NB; ++nb)
        tma_load(q_s + nb * TC_BOX, &mq, q_full, 64 * nb, h, q0, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % TC_STAGES;
        const uint32_t ph = (kt / TC_STAGES - 1) & 1;
        if (kt >= TC_STAGES) mbar_wait(k_empty + 8 * st, ph);
        mbar_expect_tx(k_full + 8 * st, NB * TC_BOX);
        for (int nb = 0; nb < NB; ++nb)
          tma_load(k_s + (st * NB + nb) * TC_BOX, &mk, k_full + 8 * st,
                   64 * nb, h, kt * TC_BN, b);
        if (kt >= TC_STAGES) mbar_wait(v_empty + 8 * st, ph);
        mbar_expect_tx(v_full + 8 * st, NB * TC_BOX);
        for (int nb = 0; nb < NB; ++nb)
          tma_load(v_s + (st * NB + nb) * TC_BOX, &mv, v_full + 8 * st,
                   64 * nb, h, kt * TC_BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      TC_CONSUMER_REGS));
  const int wg = warp >> 2;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and +8
  const int cq = 2 * (lane & 3);
  const uint32_t qa = q_s + wg * 64 * 128;
  auto masked = [&](int kt) {
    return (kt + 1) * TC_BN > a.T || (a.causal && kt == qt);
  };

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[64], alpha[2];
  uint32_t p[32];

  // tile 0: its scores and P; nothing to accumulate yet
  if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  turn_wait(wg);
  wgmma_fence();
  issue_qk<NB>(s, qa, k_s);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(k_empty);
  softmax_tile(s, p, m, l, alpha, a, 0, masked(0), row0, cq);

  for (int kt = 1; kt < nkt; ++kt) {
    const int st = kt % TC_STAGES;
    const int pst = (kt - 1) % TC_STAGES;
    mbar_wait(k_full + 8 * st, (kt / TC_STAGES) & 1);
    mbar_wait(v_full + 8 * pst, ((kt - 1) / TC_STAGES) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<NB>(s, qa, k_s + st * NB * TC_BOX);
    wgmma_commit();
    issue_pv<NB>(o, p, v_s + pst * NB * TC_BOX);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();   // S_kt is done, P_{kt-1} V_{kt-1} may still run
    fence_regs(s);
    mbar_arrive(k_empty + 8 * st);
    uint32_t pn[32];
    softmax_tile(s, pn, m, l, alpha, a, kt * TC_BN, masked(kt), row0, cq);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    fence_regs(p);
    mbar_arrive(v_empty + 8 * pst);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nb][e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int e = 0; e < 32; ++e) p[e] = pn[e];
  }

  // the last tile's P V
  const int lst = (nkt - 1) % TC_STAGES;
  mbar_wait(v_full + 8 * lst, ((nkt - 1) / TC_STAGES) & 1);
  turn_wait(wg);
  wgmma_fence();
  issue_pv<NB>(o, p, v_s + lst * NB * TC_BOX);
  wgmma_commit();
  if (wg == 0) turn_pass(wg);   // warpgroup 1 issues last
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
  fence_regs(p);

  // epilogue: l summed over the row's 4 lanes, O / l in bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* ob = a.o + b * a.so_b + h * a.so_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    if (t >= a.T) continue;
    __nv_bfloat16* row = ob + (long long)t * a.so_t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = j * 4 + i * 2;
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * nb + 8 * j + cq) =
            __floats2bfloat162_rn(o[nb][e] / l[i], o[nb][e + 1] / l[i]);
      }
  }
}

size_t tc_smem_bytes(int nb) {
  return 1024 + (size_t)nb * TC_BOX * (1 + 2 * TC_STAGES) +
         8 * (1 + 4 * TC_STAGES);
}

// A 4-D tensor map over (D, H, T, B) of one bf16 operand with its element
// strides st = (b, t, h); boxes of 64 x 1 x 128 x 1, 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                int D, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, TC_BN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
              const CUtensorMap& mv, const TcArgs& a, int B,
              cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(NB);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.nqt * B * a.H;
  flash_fwd_tc_kernel<NB>
      <<<(unsigned)blocks, TC_THREADS, bytes, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
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

// The tensor-core route: bf16 only, D 64 or 128, every pointer and every
// (b, t, h) stride 16-byte aligned (the wrapper's route rule; checked again
// here), o contiguous. Same strides layout as mxt_flash_fwd. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take or a tensor map the driver refuses.
int mxt_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                     const long long* strides, int B, int T, int H, int D,
                     float scale, int causal, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if ((strides[i] * 2) % 16 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, B, T, H, D, strides) ||
      !encode_map(&mk, k, B, T, H, D, strides + 3) ||
      !encode_map(&mv, v, B, T, H, D, strides + 6))
    return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.so_b = strides[9];
  a.so_t = strides[10];
  a.so_h = strides[11];
  a.T = T;
  a.H = H;
  a.BH = B * H;
  a.nqt = (T + TC_BM - 1) / TC_BM;
  a.causal = causal;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_tc<1>(mq, mk, mv, a, B, s)
                 : launch_tc<2>(mq, mk, mv, a, B, s);
}

}  // extern "C"
