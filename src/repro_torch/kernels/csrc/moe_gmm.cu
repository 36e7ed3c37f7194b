// Slot-LUT grouped matmul: out[g] = x[g] @ W[lut[g]] with f32 accumulation.
//
// Replaces the Pallas kernel repro/kernels/moe_gmm.py:slot_gmm (pallas_call
// at moe_gmm.py:176) with all three of its bodies: _gmm_kernel (bf16/f32
// weights), _gmm_kernel_int8 and _gmm_kernel_int4. x is [G, C, D], W the
// slot store (slot S is the zero MISS slot), lut [G] the slot each group
// reads, out [G, C, F]:
//  * bf16/f32: W [S+1, D, F] in x's type, out in x's type;
//  * int8: W [S+1, D, F] int8 with f32 scales [S+1, F]; the scale of the
//    output channel multiplies the f32 accumulator once, at the store; out f32;
//  * int4: W [S+1, D/2, F] uint8, byte p holding row 2p in its low nibble
//    and row 2p+1 in its high nibble, with f16 scales and mins
//    [S+1, D/group, F]; each weight dequantizes to q*s + m in f32 (no fused
//    multiply-add, as the plain version rounds) before the product; out f32.
//
// Bound on this card: bytes at decode (G = top-k picks, C = 1: every weight
// byte is read once and used once; packed weights are what make the
// quantized bodies' bound 2x / 3.6x lower than bf16's), operations for large
// C at prefill. Two bodies per format, picked by C in the Python wrapper
// (kernels/moe_gmm.py):
//  * C <= 4, the GEMV body: a block owns 64 output columns of one group;
//    its 16 warps stride over the D rows (int4: over the packed rows, each
//    byte giving two rows), each lane reading two neighbouring columns, and
//    a shared-memory reduction sums the warps. The weight tile is never
//    staged: it is used once.
//  * C > 4, the tiled body: 64x64 output tiles, D in steps of 32 through
//    shared memory as f32 (int4: dequantized while staged, the group of
//    each row computed per row, since a group need not align with the
//    step), 4x4 outputs per thread. CUDA cores, no tensor cores yet.
// The LUT indirection is one load per block: rotation rewrites the LUT and
// the compute never changes, as in the reference.
#include <cuda_fp16.h>

#include "common.cuh"

using namespace repro;

constexpr int GV_WARPS = 16;
constexpr int GV_COLS = 64;
constexpr int GV_MAXC = 4;

// Weight access of one slot, one struct per format: ``slot`` moves the
// pointers to slot s, ``row(d, f)`` is W[d][f] as f32, and ``epilogue`` maps
// the accumulator of column f to the output. Int4W also has ``pair(p, f)``,
// rows 2p and 2p+1 of column f from one byte (the GEMV body's step).
template <typename T>
struct DenseW {
    const T* w;
    int F;
    __device__ void slot(int s, int D) { w += (size_t)s * D * F; }
    __device__ float row(int d, int f) const { return to_f(w[(size_t)d * F + f]); }
    __device__ float epilogue(float acc, int) const { return acc; }
};

struct Int8W {
    const int8_t* w;
    const float* scale;   // [S+1, F]
    int F;
    __device__ void slot(int s, int D) {
        w += (size_t)s * D * F;
        scale += (size_t)s * F;
    }
    __device__ float row(int d, int f) const { return (float)w[(size_t)d * F + f]; }
    __device__ float epilogue(float acc, int f) const { return acc * scale[f]; }
};

struct Int4W {
    const uint8_t* w;     // [S+1, D/2, F]
    const __half* scale;  // [S+1, D/group, F]
    const __half* mn;
    int F, group;
    __device__ void slot(int s, int D) {
        w += (size_t)s * (D / 2) * F;
        scale += (size_t)s * (D / group) * F;
        mn += (size_t)s * (D / group) * F;
    }
    __device__ float deq(int q, int grp, int f) const {
        const size_t i = (size_t)grp * F + f;
        return __fadd_rn(__fmul_rn((float)q, __half2float(scale[i])), __half2float(mn[i]));
    }
    __device__ float row(int d, int f) const {
        const uint8_t b = w[(size_t)(d / 2) * F + f];
        return deq((d & 1) ? (b >> 4) : (b & 0xF), d / group, f);
    }
    // group is even, so rows 2p and 2p+1 share one scale and min
    __device__ void pair(int p, int f, float& lo, float& hi) const {
        const uint8_t b = w[(size_t)p * F + f];
        const int grp = (2 * p) / group;
        lo = deq(b & 0xF, grp, f);
        hi = deq(b >> 4, grp, f);
    }
    __device__ float epilogue(float acc, int) const { return acc; }
};

// GEMV body for DenseW/Int8W (one row per step) ...
template <typename T, typename W>
__device__ void gemv_rows(const T* X, W wt, int C, int D, int F, int fa, int fb, int warp,
                          float (&acc)[GV_MAXC][2]) {
#pragma unroll 4
    for (int d = warp; d < D; d += GV_WARPS) {
        const float wa = fa < F ? wt.row(d, fa) : 0.f;
        const float wb = fb < F ? wt.row(d, fb) : 0.f;
#pragma unroll
        for (int c = 0; c < GV_MAXC; ++c) {
            if (c < C) {
                const float xv = to_f(X[(size_t)c * D + d]);
                acc[c][0] += xv * wa;
                acc[c][1] += xv * wb;
            }
        }
    }
}

// ... and for Int4W (one packed row, two rows of W, per step)
template <typename T, typename W>
__device__ void gemv_pairs(const T* X, W wt, int C, int D, int F, int fa, int fb, int warp,
                           float (&acc)[GV_MAXC][2]) {
#pragma unroll 2
    for (int p = warp; p < D / 2; p += GV_WARPS) {
        float la = 0.f, ha = 0.f, lb = 0.f, hb = 0.f;
        if (fa < F) wt.pair(p, fa, la, ha);
        if (fb < F) wt.pair(p, fb, lb, hb);
#pragma unroll
        for (int c = 0; c < GV_MAXC; ++c) {
            if (c < C) {
                const float x0 = to_f(X[(size_t)c * D + 2 * p]);
                const float x1 = to_f(X[(size_t)c * D + 2 * p + 1]);
                acc[c][0] += x0 * la;
                acc[c][0] += x1 * ha;
                acc[c][1] += x0 * lb;
                acc[c][1] += x1 * hb;
            }
        }
    }
}

template <typename T, typename TO, typename W, bool PAIRS>
__global__ void __launch_bounds__(GV_WARPS * 32)
gmm_gemv(const T* __restrict__ x, W wt, const int32_t* __restrict__ lut,
         int C, int D, int F, TO* __restrict__ out) {
    const int g = blockIdx.y;
    const int f0 = blockIdx.x * GV_COLS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wt.slot(lut[g], D);
    const T* X = x + (size_t)g * C * D;
    const int fa = f0 + 2 * lane, fb = fa + 1;
    float acc[GV_MAXC][2];
#pragma unroll
    for (int c = 0; c < GV_MAXC; ++c) { acc[c][0] = 0.f; acc[c][1] = 0.f; }
    if constexpr (PAIRS) gemv_pairs<T>(X, wt, C, D, F, fa, fb, warp, acc);
    else gemv_rows<T>(X, wt, C, D, F, fa, fb, warp, acc);
    __shared__ float red[GV_WARPS][GV_MAXC][GV_COLS];
#pragma unroll
    for (int c = 0; c < GV_MAXC; ++c) {
        red[warp][c][2 * lane] = acc[c][0];
        red[warp][c][2 * lane + 1] = acc[c][1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C * GV_COLS; i += blockDim.x) {
        const int c = i / GV_COLS, col = i % GV_COLS;
        float s = 0.f;
#pragma unroll
        for (int wv = 0; wv < GV_WARPS; ++wv) s += red[wv][c][col];
        const int f = f0 + col;
        if (f < F) out[((size_t)g * C + c) * F + f] = from_f<TO>(wt.epilogue(s, f));
    }
}

constexpr int TL_B = 64;   // output tile rows and columns
constexpr int TL_K = 32;   // reduction step

template <typename T, typename TO, typename W>
__global__ void __launch_bounds__(256)
gmm_tiled(const T* __restrict__ x, W wt, const int32_t* __restrict__ lut,
          int C, int D, int F, TO* __restrict__ out) {
    const int g = blockIdx.z, c0 = blockIdx.y * TL_B, f0 = blockIdx.x * TL_B;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    wt.slot(lut[g], D);
    const T* X = x + (size_t)g * C * D;
    __shared__ float xs[TL_B][TL_K + 1];
    __shared__ float ws[TL_K][TL_B];
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int k0 = 0; k0 < D; k0 += TL_K) {
        for (int i = tid; i < TL_B * TL_K; i += 256) {
            const int r = i / TL_K, kk = i % TL_K, c = c0 + r, d = k0 + kk;
            xs[r][kk] = (c < C && d < D) ? to_f(X[(size_t)c * D + d]) : 0.f;
        }
        for (int i = tid; i < TL_K * TL_B; i += 256) {
            const int kk = i / TL_B, col = i % TL_B, d = k0 + kk, f = f0 + col;
            ws[kk][col] = (d < D && f < F) ? wt.row(d, f) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TL_K; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = xs[ty + 16 * r][kk];
#pragma unroll
            for (int q = 0; q < 4; ++q) b[q] = ws[kk][tx + 16 * q];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[r][q] += a[r] * b[q];
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int c = c0 + ty + 16 * r;
        if (c >= C) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int f = f0 + tx + 16 * q;
            if (f < F) out[((size_t)g * C + c) * F + f] = from_f<TO>(wt.epilogue(acc[r][q], f));
        }
    }
}

template <typename T, typename TO, typename W, bool PAIRS>
static int launch(bool tiled, const void* x, W wt, const void* lut, int G, int C, int D,
                  int F, void* out, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* xp = static_cast<const T*>(x);
    const int32_t* lp = static_cast<const int32_t*>(lut);
    TO* op = static_cast<TO*>(out);
    if (tiled) {
        const dim3 grid((F + TL_B - 1) / TL_B, (C + TL_B - 1) / TL_B, G);
        gmm_tiled<T, TO, W><<<grid, 256, 0, st>>>(xp, wt, lp, C, D, F, op);
    } else {
        if (C > GV_MAXC) return (int)cudaErrorInvalidValue;
        const dim3 grid((F + GV_COLS - 1) / GV_COLS, G);
        gmm_gemv<T, TO, W, PAIRS><<<grid, GV_WARPS * 32, 0, st>>>(xp, wt, lp, C, D, F, op);
    }
    return (int)cudaGetLastError();
}

// One C entry per body, weight format and activation type: the Python
// wrapper picks the body (GEMV for C <= GV_MAXC) and counts each body's
// launches on its own.
#define SLOT_GMM_ENTRY(name, tiled, T)                                                 \
    extern "C" int name(const void* x, const void* w, const void* lut, int G, int C,  \
                        int D, int F, void* out, void* stream) {                       \
        const DenseW<T> wt{static_cast<const T*>(w), F};                               \
        return launch<T, T, DenseW<T>, false>(tiled, x, wt, lut, G, C, D, F, out, stream); \
    }
SLOT_GMM_ENTRY(slot_gmm_gemv_bf16, false, __nv_bfloat16)
SLOT_GMM_ENTRY(slot_gmm_gemv_f32, false, float)
SLOT_GMM_ENTRY(slot_gmm_tiled_bf16, true, __nv_bfloat16)
SLOT_GMM_ENTRY(slot_gmm_tiled_f32, true, float)

#define SLOT_GMM_INT8_ENTRY(name, tiled, T)                                            \
    extern "C" int name(const void* x, const void* w, const void* scale, const void* lut, \
                        int G, int C, int D, int F, void* out, void* stream) {         \
        const Int8W wt{static_cast<const int8_t*>(w), static_cast<const float*>(scale), F}; \
        return launch<T, float, Int8W, false>(tiled, x, wt, lut, G, C, D, F, out, stream); \
    }
SLOT_GMM_INT8_ENTRY(slot_gmm_int8_gemv_bf16, false, __nv_bfloat16)
SLOT_GMM_INT8_ENTRY(slot_gmm_int8_gemv_f32, false, float)
SLOT_GMM_INT8_ENTRY(slot_gmm_int8_tiled_bf16, true, __nv_bfloat16)
SLOT_GMM_INT8_ENTRY(slot_gmm_int8_tiled_f32, true, float)

#define SLOT_GMM_INT4_ENTRY(name, tiled, T)                                            \
    extern "C" int name(const void* x, const void* w, const void* scale, const void* mn,  \
                        const void* lut, int G, int C, int D, int F, int group, void* out, \
                        void* stream) {                                                \
        if (group < 2 || group % 2 || D % group) return (int)cudaErrorInvalidValue;     \
        const Int4W wt{static_cast<const uint8_t*>(w), static_cast<const __half*>(scale), \
                       static_cast<const __half*>(mn), F, group};                      \
        return launch<T, float, Int4W, true>(tiled, x, wt, lut, G, C, D, F, out, stream); \
    }
SLOT_GMM_INT4_ENTRY(slot_gmm_int4_gemv_bf16, false, __nv_bfloat16)
SLOT_GMM_INT4_ENTRY(slot_gmm_int4_gemv_f32, false, float)
SLOT_GMM_INT4_ENTRY(slot_gmm_int4_tiled_bf16, true, __nv_bfloat16)
SLOT_GMM_INT4_ENTRY(slot_gmm_int4_tiled_f32, true, float)
