// Flash-attention forward for Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, T, H, D) tensors, optional causal mask.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/pallas_kernels.py:
//   mxt_flash_fwd_tc       <- _build_flash (the pallas_call of
//                             flash_attention), for bf16 and f16 with D a
//                             multiple of 8 up to 256 and aligned views
//   mxt_flash_fwd          <- the same, for every other call (the general
//                             route: f32, any D, any view)
// The TPU kernel upcasts q, k and v to f32, takes f32 logits, the -1e30
// causal mask and one full-row softmax, divides by l and returns q's dtype;
// it takes any T and any D. The Python wrapper, its route rule and the plain
// PyTorch version live in mxnet_tpu_torch/ops/flash_attention.py. Two
// kernels, chosen by shape:
//
// flash_fwd_tc_kernel (mxt_flash_fwd_tc): bf16 or f16, D a multiple of 8 up
// to 256, pointers and (b, t, h) strides 16-byte aligned. The two products
// run on the tensor cores with wgmma in the input type; TMA brings the
// tiles in. Bound on the card: the work is 4*B*H*T^2*D flops (halved when
// causal) against 4*B*T*H*D*2 bytes, T/4 flops per byte when causal, 512 at
// T = 2048, above the ~295 at which the H100's 16-bit tensor cores (989
// TFLOP/s) stop waiting on memory: it is bound by operations. The design,
// per block of 384 threads:
//   - a block owns one (b, h) and 128 query rows, two consumer warpgroups
//     of 64 rows each; the heaviest query tiles are scheduled first;
//   - D is held as NB = ceil(D / 64) boxes of 64 columns. A D that is not a
//     multiple of 64 is padded in shared memory: the tensor maps' D extent
//     is the true D, so the columns of the last box past D arrive as zeros
//     (TMA's out-of-bounds fill), add nothing to Q K^T, give zero columns of
//     O, and are never stored. D 64 and 128 take instances with no column
//     mask (PAD false), and 128-key tiles the query tile's causal rule
//     (tile kt == qt holds the diagonal);
//   - a producer warpgroup (one thread issues; setmaxnreg hands its
//     registers to the consumers, 40 against 232) makes TMA loads of the Q
//     tile and of BN-row K and V tiles into a ring of 2 stages, signalled
//     by mbarriers, through one 4-D tensor map per operand over (D, H, T,
//     B) with the views' strides (so the q/k/v views of a fused qkv
//     projection go in without a copy); rows past T arrive as zeros. Tiles
//     are 128-byte swizzled: a 64-column box is one 128-byte row per key.
//     K and V stages are released separately. BN is 128 for NB <= 2 and 64
//     for NB 3 and 4 (D 136 to 256): 2 stages of 128-row K and V tiles
//     take 4 * NB * 32 KB, which with the Q tile is 240 KB at NB = 3 and
//     320 KB at NB = 4, past the 227 KB a block may hold; 64-row tiles keep
//     the 2-stage ring (144 and 192 KB with Q), so loads still overlap the
//     products, and keep S at 32 registers a thread beside O's 32 * NB (one
//     stage of 128-row tiles would fit in shared memory but not S's 64
//     registers beside O's 128 at NB = 4);
//   - S = Q K^T with wgmma.m64nBNk16, both operands in shared memory
//     (K-major), f32 accumulators;
//   - the online softmax in f32 registers on the accumulator fragments
//     (row max over the 4 lanes that share a row, running m and l, O
//     rescaled), in base 2 with the scale folded into log2(e);
//   - O += P V with wgmma.m64n64k16 per 64 columns of D: P converted to the
//     input type in registers is the A operand (the accumulator layout of S
//     is the A-fragment layout, 16 keys at a time); V is the B operand from
//     shared memory, MN-major (the descriptor's transpose bit);
//   - each warpgroup issues S of tile kt and P V of tile kt - 1 together
//     and takes the softmax of tile kt while the second product runs; the
//     two warpgroups take turns to issue (named barriers), so one's
//     softmax overlaps the other's products. At D 64 the exponentials
//     (16 a clock per SM) take as long per tile as the tensor cores;
//   - O / l rounded to the input type and stored through the output's
//     strides, the columns past D left out.
// Causal blocks stop at the tile that holds their last row; only tiles
// that cross the diagonal and a ragged last tile are masked. Tolerance
// against the f32 plain version: Q K^T of 16-bit inputs is exact in f32 and
// P is the only new rounding: P in bf16 has a relative error of at most
// 2^-8 per element (f16: 2^-11), so the output moves by at most 2^-8 max|v|
// (f16: 2^-11 max|v|) before its own rounding to the output type. An
// element passes when |got - want| <= 2e-5 + 2^-7 |want| + 2^-8 max|v| in
// bf16 and 2e-5 + 2^-10 |want| + 2^-11 max|v| in f16.
//
// flash_fwd_general_kernel (mxt_flash_fwd): every other call: f32 at any
// D, f16 and bf16 at a D the tensor-core route does not take or through
// views it cannot map (pointers or strides not 16-byte aligned), any T >= 1
// and any D >= 1. Both products run on the tensor cores with
// mma.sync.m16n8k8 in TF32 with f32 accumulation. TF32 keeps 11 bits of
// the significand, so an f32 operand is split as a = hi + lo, hi =
// tf32(a), lo = tf32(a - hi) (what hi + lo misses is about 2^-22 |a|;
// tf32() rounds to nearest, ties away, in two integer operations), and
// a product takes three passes, hi*lo + lo*hi + hi*hi ("3xTF32"): the
// dropped lo*lo term is about 2^-22 of each product, below the f32
// rounding the plain version makes itself. 16-bit inputs are exact in
// TF32, so Q K^T of f16 or bf16 is one pass; P is f32 and is split, so
// P V of 16-bit V is two passes. Bound on the card: the same flops as
// above; at the LM's default shape (B 8, T 2048, H 8, D 64, causal, f32)
// 34.4 GFLOP and 134 MB, 0.513 ms on f32 FMAs (67 TFLOP/s) and 0.208 ms
// as 3xTF32 on the tensor cores (3 x 34.4 GFLOP at 495 TFLOP/s): bound by
// operations. The design, per block of 128 threads (4 warps):
//   - a block owns one (b, h), 64 query rows (16 per warp) and DV columns
//     of O, DV = 64 for D <= 64 (O in 32 registers a thread) and 128
//     above; a D above 128 splits O's columns over ceil(D / 128) blocks,
//     each of which recomputes S over the whole D for its slice;
//   - K/V tiles of 64 keys, walked as a sequence of items: per tile the
//     Q/K chunks of 64 columns of D, then the V chunks of 64 columns of the
//     block's O slice. cp.async copies (16, 8 or 4 bytes, the largest that
//     every pointer and stride allows; element by element for 16-bit views
//     that are not 4-byte aligned) fill a ring of 3 stages in shared
//     memory, so two items are in flight while one is used; TMA would need
//     16-byte strides that these views may lack. Elements past T or D
//     arrive as zeros (cp.async's source size);
//   - the Q tile stays in shared memory for D <= 128 and comes in by chunk
//     beside K otherwise;
//   - S (16 x 64 per warp, 32 registers) accumulates the chunks' products;
//     the online softmax runs on its fragments in f32 with expf (row max
//     over the 4 lanes that share a row, running m and l, O rescaled);
//   - P V takes P straight from S's registers: the accumulator holds keys
//     2t and 2t + 1 of each 8 where the A fragment wants t and t + 4, so
//     the keys of each 8 are taken in the order 0 2 4 6 1 3 5 7 in both P
//     and V (Q K^T pairs its columns of D alike, so every fragment of Q and
//     K is one 8-byte or 4-byte load). Rows of Q and K are padded to 72
//     elements and rows of V to 68 (f32) or 72 (16-bit), so a warp's
//     fragment loads fall in distinct banks;
//   - O / l in the output type, the columns past D and rows past T left
//     out.
// Tolerance against the f32 plain version: 2e-5 absolute for f32 outputs
// (plus one unit in the last place of a 16-bit output: 2^-7 |want| in
// bf16, 2^-10 |want| in f16).
//
// Masking, as the reference does it, in both kernels: causal positions get
// -1e30, so once a row has seen a real score (column 0 is in the first tile
// of every row) their exp is exactly 0 in f32. Columns past T (ragged T)
// are -inf and rows past T are computed from zeros and not written.
//
// Layout: q, k, v and o are read and written through their (b, t, h)
// strides in elements, with the last dim contiguous, so the q/k/v views of
// a fused qkv projection go in without copies. No atomics, no allocation.

#include <cuda.h>   // CUtensorMap, cuTensorMapEncodeTiled (linked -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// ---------------------------------------------------------------------------
// flash_fwd_general_kernel: the general route (mma.sync TF32, cp.async)
// ---------------------------------------------------------------------------

constexpr int GQ = 64;          // query rows per block, 16 per warp
constexpr int GK = 64;          // keys per tile
constexpr int GC = 64;          // columns per Q/K chunk and per V chunk
constexpr int GQ_HELD = 128;    // Q stays in shared memory up to this D
constexpr int G_THREADS = 128;
constexpr int G_STAGES = 3;
constexpr int KLD = GC + 8;     // row of a Q or K chunk in shared memory

// row of a V chunk: 68 f32 (272 bytes) or 72 16-bit elements (144 bytes),
// 16-byte multiples for cp.async whose fragment loads hit distinct banks
template <typename T>
__host__ __device__ constexpr int vld() {
  return sizeof(T) == 4 ? GC + 4 : GC + 8;
}

// elements of one stage: a K chunk (and a Q chunk when Q is not held) or
// a V chunk
__host__ __device__ inline int g_stage(bool held) {
  return (held ? GK : GQ + GK) * KLD;
}

struct GArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int T, H, D, BH, nqt, nsplit;
  float scale;
  int causal, unit;
};

// Two consecutive elements (an even index) as f32.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld1(const __half* p) {
  return __half2float(*p);
}

// `bytes` of one cp.async copy of `unit` bytes (16, 8 or 4); the rest of
// the unit is zero-filled.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int unit, int bytes) {
  if (unit == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) and columns [col0, col0 + GC) of one (b, h) slice
// of a (T, D) operand with row stride st (elements) into a [64][ld] tile in
// shared memory; elements past T or D arrive as zeros. unit >= 4: cp.async
// copies of `unit` bytes (asynchronous, joined by the next commit); unit 2
// (16-bit views that are not 4-byte aligned): element by element.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* base,
                                          long long st, int row0, int col0,
                                          int T_, int D, int unit) {
  constexpr int ES = sizeof(T);
  if (unit >= 4) {
    const int ue = unit / ES;       // elements per copy
    const int upr = GC / ue;        // copies per row
    for (int idx = threadIdx.x; idx < 64 * upr; idx += G_THREADS) {
      const int r = idx / upr;
      const int c = (idx - r * upr) * ue;
      const int t = row0 + r;
      const int n = t < T_ ? max(0, min(D - (col0 + c), ue)) : 0;
      const T* src = n > 0 ? base + (long long)t * st + col0 + c : base;
      cp_async(smem_u32(dst + r * ld + c), src, unit, n * ES);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * GC; idx += G_THREADS) {
      const int r = idx / GC;
      const int c = idx - r * GC;
      const int t = row0 + r;
      dst[r * ld + c] = (t < T_ && col0 + c < D)
                            ? base[(long long)t * st + col0 + c]
                            : from_f32<T>(0.f);
    }
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), in two full-rate integer operations: half a unit of the 13 low
// bits of the significand added to the magnitude, then those bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Build switches for timing what the split costs (tools/
// kernel_variants_probe.py); both give wrong results when changed:
// MXT_TF32_PASSES 1 issues only hi * hi, MXT_TF32_SPLIT 0 passes the f32
// bits as hi and zero as lo.
#ifndef MXT_TF32_PASSES
#define MXT_TF32_PASSES 3
#endif
#ifndef MXT_TF32_SPLIT
#define MXT_TF32_SPLIT 1
#endif

// a = hi + lo, each exact in TF32 (lo also rounded to TF32).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
#if MXT_TF32_SPLIT
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
#else
  return {__float_as_uint(x), 0u};
#endif
}

// d (16 x 8, f32) += A (16 x 8) B (8 x 8), TF32 operands. Fragments, with
// g = lane / 4 and t = lane % 4: A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; B[t][g], B[t + 4][g]; d[g][2t], d[g][2t + 1],
// d[g + 8][2t], d[g + 8][2t + 1].
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B with both operands split: the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], Split b0,
                                     Split b1) {
#if MXT_TF32_PASSES == 3
  mma8(d, al, b0.hi, b1.hi);
  mma8(d, ah, b0.lo, b1.lo);
#endif
  mma8(d, ah, b0.hi, b1.hi);
}

// S (16 x 64 per warp) += Q_c K_c^T over one chunk of GC columns of D, of
// which `cols` are real (the rest are zeros; steps of 8 past them are
// skipped). Column pair (2t, 2t + 1) of each step of 8 stands in the A and
// B fragments' places t and t + 4, so each fragment pair is one load.
template <typename T>
__device__ __forceinline__ void qk_chunk(float (&s)[8][4], const T* qs,
                                         int qld, const T* ks, int cols,
                                         int w, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < GC / 8; ++kk) {
    if (kk * 8 >= cols) break;
    const int d0 = kk * 8 + 2 * t;
    const float2 qa = ld2(qs + (16 * w + g) * qld + d0);
    const float2 qb = ld2(qs + (16 * w + g + 8) * qld + d0);
    if constexpr (std::is_same<T, float>::value) {
      const Split x0 = split(qa.x), x1 = split(qb.x), x2 = split(qa.y),
                  x3 = split(qb.y);
      const uint32_t ah[4] = {x0.hi, x1.hi, x2.hi, x3.hi};
      const uint32_t al[4] = {x0.lo, x1.lo, x2.lo, x3.lo};
#pragma unroll
      for (int nt = 0; nt < GK / 8; ++nt) {
        const float2 kv = ld2(ks + (8 * nt + g) * KLD + d0);
        mma3(s[nt], ah, al, split(kv.x), split(kv.y));
      }
    } else {   // 16-bit inputs are exact in TF32: one pass
      const uint32_t a[4] = {__float_as_uint(qa.x), __float_as_uint(qb.x),
                             __float_as_uint(qa.y), __float_as_uint(qb.y)};
#pragma unroll
      for (int nt = 0; nt < GK / 8; ++nt) {
        const float2 kv = ld2(ks + (8 * nt + g) * KLD + d0);
        mma8(s[nt], a, __float_as_uint(kv.x), __float_as_uint(kv.y));
      }
    }
  }
}

// The online softmax of one tile's scores, in place: s becomes P. Thread
// (g, t) of warp w holds rows r0 = q0 + 16w + g (s[nt][0..1]) and r0 + 8
// (s[nt][2..3]), columns k0 + 8nt + 2t + (0, 1). Updates the running max m
// and this thread's share of the row sums l, and rescales O.
template <int NO>
__device__ __forceinline__ void g_softmax(float (&s)[8][4], float (&m)[2],
                                          float (&l)[2], float (&o)[NO][4],
                                          const GArgs& a, int k0, int r0,
                                          int t) {
  float mx[2] = {-INFINITY, -INFINITY};
  const bool masked = k0 + GK > a.T || (a.causal && k0 + GK - 1 > r0);
#pragma unroll
  for (int nt = 0; nt < GK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * a.scale;
      if (masked) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * t + (e & 1);
        if (a.causal && col > row) x = -1e30f;
        if (col >= a.T) x = -INFINITY;
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    base[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    alpha[i] = expf(m[i] - base[i]);
    m[i] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < GK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[nt][e] - base[e >> 1]);
      s[nt][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
}

// O[:, GC vc ..] += P V_vc over one V chunk of GC columns, `cols` of them
// real. Keys 8j + 2t and 8j + 2t + 1 stand in the A and B fragments'
// places t and t + 4 (the accumulator layout of S), so P comes straight
// from S's registers.
template <typename T, int NO>
__device__ __forceinline__ void pv_chunk(float (&o)[NO][4],
                                         const float (&p)[8][4], const T* vs,
                                         int vc, int cols, int g, int t) {
  constexpr int VLD = vld<T>();
  constexpr int NC = GC / 8;   // n-tiles of O per V chunk
#pragma unroll
  for (int j = 0; j < GK / 8; ++j) {
    const Split x0 = split(p[j][0]), x1 = split(p[j][2]), x2 = split(p[j][1]),
                x3 = split(p[j][3]);
    const uint32_t ah[4] = {x0.hi, x1.hi, x2.hi, x3.hi};
    const uint32_t al[4] = {x0.lo, x1.lo, x2.lo, x3.lo};
    const T* v0 = vs + (8 * j + 2 * t) * VLD + g;
    const T* v1 = v0 + VLD;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      if (nt / NC != vc || (nt % NC) * 8 >= cols) continue;
      const float b0 = ld1(v0 + 8 * (nt % NC));
      const float b1 = ld1(v1 + 8 * (nt % NC));
      if constexpr (std::is_same<T, float>::value) {
        mma3(o[nt], ah, al, split(b0), split(b1));
      } else {   // V exact in TF32: P's two halves
        mma8(o[nt], al, __float_as_uint(b0), __float_as_uint(b1));
        mma8(o[nt], ah, __float_as_uint(b0), __float_as_uint(b1));
      }
    }
  }
}

// Block (column slice cs, (b, h), query tile qt), heaviest tiles first;
// DV columns of O per block (64 for D <= 64, else 128). Item i of its walk
// is part j = i % ipt of key tile i / ipt: the Q/K chunk j for j < nqk,
// else the V chunk j - nqk. Step i waits for item i, then issues item i + 2
// into the stage item i - 1 used.
template <typename T, int DV>
__global__ void __launch_bounds__(G_THREADS)
    flash_fwd_general_kernel(const GArgs a) {
  constexpr int NO = DV / 8;   // n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char g_smem[];
  T* stages = reinterpret_cast<T*>(g_smem);
  const bool held = a.D <= GQ_HELD;
  const int stage = g_stage(held);
  const int qld = held ? (a.D + GC - 1) / GC * GC + 8 : KLD;
  T* qs_held = stages + G_STAGES * stage;

  int idx = blockIdx.x;
  const int cs = idx % a.nsplit;
  idx /= a.nsplit;
  const int bh = idx % a.BH;
  const int qt = a.nqt - 1 - idx / a.BH;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * GQ;
  const int c0 = cs * DV;
  const int dv = min(DV, a.D - c0);
  const int nqk = (a.D + GC - 1) / GC;
  const int ipt = nqk + (dv + GC - 1) / GC;
  const int nk_all = (a.T + GK - 1) / GK;
  const int nkt = a.causal ? min(qt + 1, nk_all) : nk_all;   // GQ == GK
  const int total = nkt * ipt;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;

  auto issue = [&](int i) {
    if (i < total) {
      const int kt = i / ipt;
      const int j = i - kt * ipt;
      T* st = stages + (i % G_STAGES) * stage;
      if (j < nqk) {
        if (!held)
          load_rows<T>(st + GK * KLD, KLD, qb, a.sq.t, q0, j * GC, a.T, a.D,
                       a.unit);
        load_rows<T>(st, KLD, kb, a.sk.t, kt * GK, j * GC, a.T, a.D, a.unit);
      } else {
        load_rows<T>(st, vld<T>(), vb, a.sv.t, kt * GK,
                     c0 + (j - nqk) * GC, a.T, a.D, a.unit);
      }
    }
    cp_async_commit();
  };

  if (held)   // joins item 0's group
    for (int c = 0; c < nqk; ++c)
      load_rows<T>(qs_held + c * GC, qld, qb, a.sq.t, q0, c * GC, a.T, a.D,
                   a.unit);
  for (int i = 0; i < G_STAGES - 1; ++i) issue(i);

  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + 16 * w + g;
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float s[GK / 8][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int i = 0, kt = 0, j = 0; i < total; ++i) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    issue(i + G_STAGES - 1);
    const T* st = stages + (i % G_STAGES) * stage;
    if (j < nqk) {
      if (j == 0) {
#pragma unroll
        for (int nt = 0; nt < GK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      qk_chunk<T>(s, held ? qs_held + j * GC : st + GK * KLD,
                  held ? qld : KLD, st, a.D - j * GC, w, g, t);
      if (j == nqk - 1) g_softmax<NO>(s, m, l, o, a, kt * GK, r0, t);
    } else {
      pv_chunk<T, NO>(o, s, st, j - nqk, dv - (j - nqk) * GC, g, t);
    }
    if (++j == ipt) {
      j = 0;
      ++kt;
    }
  }
  cp_async_wait<0>();   // the trailing (empty) groups

  // epilogue: l summed over the row's 4 lanes, O / l in the output type
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= a.T) continue;
    T* orow = ob + (long long)row * a.so.t;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        if (col < dv) orow[col] = from_f32<T>(o[nt][2 * i + c] / l[i]);
      }
  }
}

size_t general_smem_bytes(int D, int es) {
  const bool held = D <= GQ_HELD;
  const size_t q = held ? (size_t)GQ * ((D + GC - 1) / GC * GC + 8) : 0;
  return (size_t)es * ((size_t)G_STAGES * g_stage(held) + q);
}

template <typename T, int DV>
int launch_general(const GArgs& a, int B, cudaStream_t stream) {
  const size_t bytes = general_smem_bytes(a.D, sizeof(T));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_general_kernel<T, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.nqt * B * a.H * a.nsplit;
  flash_fwd_general_kernel<T, DV>
      <<<(unsigned)blocks, G_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// DV 64 for D <= 64 (O in 32 registers a thread), else 128 with
// ceil(D / 128) column slices
template <typename T>
int dispatch_general(GArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 64) {
    a.nsplit = 1;
    return launch_general<T, 64>(a, B, stream);
  }
  a.nsplit = (a.D + 127) / 128;
  return launch_general<T, 128>(a, B, stream);
}

// ---------------------------------------------------------------------------
// flash_fwd_tc_kernel: the tensor-core route (bf16 or f16, D % 8 == 0, <= 256)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;          // query rows per block (2 x 64)
constexpr int TC_STAGES = 2;        // K/V ring
constexpr int TC_THREADS = 384;     // warpgroups 0-1 consume, 2 loads
constexpr int TC_CONSUMERS = 256;
constexpr int TC_PRODUCER_REGS = 40;    // setmaxnreg: the loader gives up
constexpr int TC_CONSUMER_REGS = 232;   // registers to the consumers
constexpr int TC_QBOX = TC_BM * 128;    // one 64-column box of Q: 128 x 128 B

// bytes of one 64-column box of a BN-row K or V tile
template <int BN>
__host__ __device__ constexpr int kv_box() {
  return BN * 128;
}

struct TcArgs {
  void* o;
  long long so_b, so_t, so_h;
  int T, H, D, BH, nqt, causal;
  float scale_log2;   // scale * log2(e)
};

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

// One 4-D TMA box (64 columns of D, 1 head, the map's rows of T, 1 batch)
// into shared memory, completing on `bar`.
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
// 1024 bytes apart; one swizzle atom spans the product's 64 columns (the
// leading offset, one box, would step to the next 64 columns).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t box) {
  return smem_desc(addr, box, 1024);
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
#define MXT_QK128(TY)                                                   \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "    \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "    \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"                        \
      : MXT_F8(d, 0), MXT_F8(d, 8), MXT_F8(d, 16), MXT_F8(d, 24),       \
        MXT_F8(d, 32), MXT_F8(d, 40), MXT_F8(d, 48), MXT_F8(d, 56)      \
      : "l"(da), "l"(db), "r"(accumulate))

// d[32] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory.
#define MXT_QK64(TY)                                                    \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "    \
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"    \
      : MXT_F8(d, 0), MXT_F8(d, 8), MXT_F8(d, 16), MXT_F8(d, 24)        \
      : "l"(da), "l"(db), "r"(accumulate))

// d[32] += A[64 x 16] B[16 x 64], A (pairs of the input type) in
// registers, B MN-major in shared memory (transpose bit set).
#define MXT_PV(TY)                                                      \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "    \
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "      \
      "p, 1, 1, 1;\n}\n"                                                \
      : MXT_F8(d, 0), MXT_F8(d, 8), MXT_F8(d, 16), MXT_F8(d, 24)        \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) MXT_QK128("f16");
  else MXT_QK128("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) MXT_QK64("f16");
  else MXT_QK64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) MXT_PV("f16");
  else MXT_PV("bf16");
}

#undef MXT_QK128
#undef MXT_QK64
#undef MXT_PV
#undef MXT_F8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to a pair of the input type, as the A fragment's
// 32-bit register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup holds
// rows 16*(t/32) + (t%32)/4 + 8*i (i < 2) and columns 8*j + 2*(t%4) + c
// (c < 2) in register j*4 + i*2 + c. NB = ceil(D / 64) boxes per tile.

// S = Q K^T of one tile, 16 columns of D per wgmma (32 bytes into each
// 128-byte row), the padded columns included (they are zeros); issued, not
// committed. A fixed sequence of wgmma, with no branch between them.
template <typename T, int NB, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t qa,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_qk<T>(s, desc_kmajor(qa + (kk >> 2) * TC_QBOX + col),
                desc_kmajor(ks + (kk >> 2) * kv_box<BN>() + col), kk > 0);
  }
}

// O += P V of one tile: keys 16*kk .. +15 are the A-fragment registers
// p[4kk .. 4kk+3], 64 columns of D per wgmma; issued, not committed.
template <typename T, int NB, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[NB][32],
                                         const uint32_t (&p)[BN / 4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_pv<T>(o[nb], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                  p[4 * kk + 3],
                  desc_mnmajor(vs + nb * kv_box<BN>() + kk * 2048,
                               kv_box<BN>()));
}

// The online softmax of one tile's scores, base 2 (x = s * scale *
// log2(e)): updates the running max m and this thread's share of the row
// sums l, writes P as pairs of the input type in A-fragment order and the
// factor alpha by which the accumulator of the earlier tiles must be
// rescaled.
template <typename T, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             uint32_t (&p)[BN / 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const TcArgs& a, int k0,
                                             bool masked, int row0, int cq) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
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
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = fast_exp2(s[j * 4 + i * 2] - base[i]);
      const float p1 = fast_exp2(s[j * 4 + i * 2 + 1] - base[i]);
      rs[i] += p0 + p1;
      p[j * 2 + i] = pack2<T>(p0, p1);
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
// nkt + 1 issues each, warpgroup 0 first. PAD: D < 64 * NB, the epilogue
// masks the columns past D.
template <typename T, int NB, int BN, bool PAD>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const TcArgs a) {
  constexpr int KVB = kv_box<BN>();
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NB * TC_QBOX;   // stage st at + st * NB * KVB
  const uint32_t v_s = k_s + TC_STAGES * NB * KVB;
  const uint32_t bars = v_s + TC_STAGES * NB * KVB;
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
  const int nk_all = (a.T + BN - 1) / BN;
  // causal: the key tiles up to the block's last row
  const int nkt = !a.causal ? nk_all
                  : BN == TC_BM ? qt + 1
                                : min((q0 + TC_BM + BN - 1) / BN, nk_all);

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
      mbar_expect_tx(q_full, NB * TC_QBOX);
      for (int nb = 0; nb < NB; ++nb)
        tma_load(q_s + nb * TC_QBOX, &mq, q_full, 64 * nb, h, q0, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % TC_STAGES;
        const uint32_t ph = (kt / TC_STAGES - 1) & 1;
        if (kt >= TC_STAGES) mbar_wait(k_empty + 8 * st, ph);
        mbar_expect_tx(k_full + 8 * st, NB * KVB);
        for (int nb = 0; nb < NB; ++nb)
          tma_load(k_s + (st * NB + nb) * KVB, &mk, k_full + 8 * st,
                   64 * nb, h, kt * BN, b);
        if (kt >= TC_STAGES) mbar_wait(v_empty + 8 * st, ph);
        mbar_expect_tx(v_full + 8 * st, NB * KVB);
        for (int nb = 0; nb < NB; ++nb)
          tma_load(v_s + (st * NB + nb) * KVB, &mv, v_full + 8 * st,
                   64 * nb, h, kt * BN, b);
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
  // a tile is masked where it holds columns past T or, causal, columns
  // past the block's first row
  auto masked = [&](int kt) {
    if constexpr (BN == TC_BM)
      return (kt + 1) * BN > a.T || (a.causal && kt == qt);
    return (kt + 1) * BN > a.T || (a.causal && (kt + 1) * BN > q0 + 1);
  };

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[BN / 2], alpha[2];
  uint32_t p[BN / 4];

  // tile 0: its scores and P; nothing to accumulate yet
  if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  turn_wait(wg);
  wgmma_fence();
  issue_qk<T, NB, BN>(s, qa, k_s);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(k_empty);
  softmax_tile<T, BN>(s, p, m, l, alpha, a, 0, masked(0), row0, cq);

  for (int kt = 1; kt < nkt; ++kt) {
    const int st = kt % TC_STAGES;
    const int pst = (kt - 1) % TC_STAGES;
    mbar_wait(k_full + 8 * st, (kt / TC_STAGES) & 1);
    mbar_wait(v_full + 8 * pst, ((kt - 1) / TC_STAGES) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<T, NB, BN>(s, qa, k_s + st * NB * KVB);
    wgmma_commit();
    issue_pv<T, NB, BN>(o, p, v_s + pst * NB * KVB);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();   // S_kt is done, P_{kt-1} V_{kt-1} may still run
    fence_regs(s);
    mbar_arrive(k_empty + 8 * st);
    uint32_t pn[BN / 4];
    softmax_tile<T, BN>(s, pn, m, l, alpha, a, kt * BN, masked(kt), row0,
                        cq);
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
    for (int e = 0; e < BN / 4; ++e) p[e] = pn[e];
  }

  // the last tile's P V
  const int lst = (nkt - 1) % TC_STAGES;
  mbar_wait(v_full + 8 * lst, ((nkt - 1) / TC_STAGES) & 1);
  turn_wait(wg);
  wgmma_fence();
  issue_pv<T, NB, BN>(o, p, v_s + lst * NB * KVB);
  wgmma_commit();
  if (wg == 0) turn_pass(wg);   // warpgroup 1 issues last
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
  fence_regs(p);

  // epilogue: l summed over the row's 4 lanes, O / l in the input type,
  // the columns past D left out (D and each pair's column are even)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* ob = static_cast<T*>(a.o) + b * a.so_b + h * a.so_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    if (t >= a.T) continue;
    T* row = ob + (long long)t * a.so_t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + cq;
        if (PAD && col >= a.D) continue;
        const int e = j * 4 + i * 2;
        *reinterpret_cast<uint32_t*>(row + col) =
            pack2<T>(o[nb][e] / l[i], o[nb][e + 1] / l[i]);
      }
  }
}

size_t tc_smem_bytes(int nb, int bn) {
  return 1024 + (size_t)nb * TC_QBOX + (size_t)nb * bn * 128 * 2 * TC_STAGES +
         8 * (1 + 4 * TC_STAGES);
}

// A 4-D tensor map over (D, H, T, B) of one 16-bit operand with its element
// strides st = (b, t, h); boxes of 64 x 1 x rows x 1, 128-byte swizzle.
// Box columns past D and rows past T read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int B, int T, int H, int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NB, int BN, bool PAD>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
              const CUtensorMap& mv, const TcArgs& a, int B,
              cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(NB, BN);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, NB, BN, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.nqt * B * a.H;
  flash_fwd_tc_kernel<T, NB, BN, PAD>
      <<<(unsigned)blocks, TC_THREADS, bytes, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
                const CUtensorMap& mv, const TcArgs& a, int B,
                cudaStream_t s) {
  const bool pad = a.D % 64 != 0;
  switch ((a.D + 63) / 64) {
    case 1:
      return pad ? launch_tc<T, 1, 128, true>(mq, mk, mv, a, B, s)
                 : launch_tc<T, 1, 128, false>(mq, mk, mv, a, B, s);
    case 2:
      return pad ? launch_tc<T, 2, 128, true>(mq, mk, mv, a, B, s)
                 : launch_tc<T, 2, 128, false>(mq, mk, mv, a, B, s);
    case 3: return launch_tc<T, 3, 64, true>(mq, mk, mv, a, B, s);
    default: return launch_tc<T, 4, 64, true>(mq, mk, mv, a, B, s);
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, t, h) of q, k, v and o in that order; the
// last dim of each is contiguous. dtype 0 = float32, 1 = bfloat16, 2 =
// float16. unit: bytes per cp.async copy (16, 8 or 4; 2 for 16-bit views
// that are not 4-byte aligned), a divisor of every pointer and every
// (b, t, h) stride of q, k and v in bytes. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  const long long* strides, int B, int T, int H, int D,
                  float scale, int causal, int dtype, int unit,
                  void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (B < 1 || T < 1 || H < 1 || D < 1 || dtype < 0 || dtype > 2 ||
      (unit != 16 && unit != 8 && unit != 4 && unit != 2) || unit < es)
    return (int)cudaErrorInvalidValue;
  GArgs a;
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
  a.nqt = (T + GQ - 1) / GQ;
  a.scale = scale;
  a.causal = causal;
  a.unit = unit;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_general<float>(a, B, s);
  if (dtype == 1) return dispatch_general<__nv_bfloat16>(a, B, s);
  return dispatch_general<__half>(a, B, s);
}

// The tensor-core route: dtype 1 = bfloat16, 2 = float16; D a multiple of 8
// from 8 to 256; every pointer and every (b, t, h) stride 16-byte aligned
// (the wrapper's route rule; checked again here). Same strides layout as
// mxt_flash_fwd. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take or a tensor
// map that cuTensorMapEncodeTiled refuses.
int mxt_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                     const long long* strides, int B, int T, int H, int D,
                     float scale, int causal, int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 8 || D > 256 || D % 8 != 0 ||
      (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if ((strides[i] * 2) % 16 != 0) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type = dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int bn = D <= 128 ? 128 : 64;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, type, B, T, H, D, strides, TC_BM) ||
      !encode_map(&mk, k, type, B, T, H, D, strides + 3, bn) ||
      !encode_map(&mv, v, type, B, T, H, D, strides + 6, bn))
    return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.o = o;
  a.so_b = strides[9];
  a.so_t = strides[10];
  a.so_h = strides[11];
  a.T = T;
  a.H = H;
  a.D = D;
  a.BH = B * H;
  a.nqt = (T + TC_BM - 1) / TC_BM;
  a.causal = causal;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return dispatch_tc<__nv_bfloat16>(mq, mk, mv, a, B, s);
  return dispatch_tc<__half>(mq, mk, mv, a, B, s);
}

}  // extern "C"
