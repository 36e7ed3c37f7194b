// Slot-LUT grouped matmul: out[g] = x[g] @ W[lut[g]] with f32 accumulation.
//
// Replaces the bf16/f32 body of the Pallas kernel
// repro/kernels/moe_gmm.py:_gmm_kernel (pallas_call at moe_gmm.py:176); the
// int8/int4 bodies are not ported yet. x is [G, C, D], W the slot store
// [S+1, D, F] (slot S is the zero MISS slot), lut [G] the slot each group
// reads, out [G, C, F] in the input type.
//
// Bound on this card: bytes at decode (G = top-k picks, C = 1: every weight
// element is read once and used once), operations for large C at prefill.
// Two bodies, picked by C in the Python wrapper (kernels/moe_gmm.py):
//  * C <= 4, the GEMV body: a block owns 64 output columns of one group;
//    its 16 warps stride over the D rows, each warp reading one 128-byte row
//    segment of W per step (coalesced), and a shared-memory reduction sums
//    the warps. The weight tile is never staged: it is used once.
//  * C > 4, the tiled body: 64x64 output tiles, D in steps of 32 through
//    shared memory, 4x4 outputs per thread. CUDA cores, no tensor cores yet.
// The LUT indirection is one load per block: rotation rewrites the LUT and
// the compute never changes, as in the reference.
#include "common.cuh"

using namespace repro;

constexpr int GV_WARPS = 16;
constexpr int GV_COLS = 64;
constexpr int GV_MAXC = 4;

template <typename T>
__global__ void __launch_bounds__(GV_WARPS * 32)
gmm_gemv(const T* __restrict__ x, const T* __restrict__ w, const int32_t* __restrict__ lut,
         int C, int D, int F, T* __restrict__ out) {
    const int g = blockIdx.y;
    const int f0 = blockIdx.x * GV_COLS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const T* W = w + (size_t)lut[g] * D * F;
    const T* X = x + (size_t)g * C * D;
    const int fa = f0 + 2 * lane, fb = fa + 1;
    float acc[GV_MAXC][2];
#pragma unroll
    for (int c = 0; c < GV_MAXC; ++c) { acc[c][0] = 0.f; acc[c][1] = 0.f; }
#pragma unroll 4
    for (int d = warp; d < D; d += GV_WARPS) {
        const T* wr = W + (size_t)d * F;
        const float wa = fa < F ? to_f(wr[fa]) : 0.f;
        const float wb = fb < F ? to_f(wr[fb]) : 0.f;
#pragma unroll
        for (int c = 0; c < GV_MAXC; ++c) {
            if (c < C) {
                const float xv = to_f(X[(size_t)c * D + d]);
                acc[c][0] += xv * wa;
                acc[c][1] += xv * wb;
            }
        }
    }
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
        if (f < F) out[((size_t)g * C + c) * F + f] = from_f<T>(s);
    }
}

constexpr int TL_B = 64;   // output tile rows and columns
constexpr int TL_K = 32;   // reduction step

template <typename T>
__global__ void __launch_bounds__(256)
gmm_tiled(const T* __restrict__ x, const T* __restrict__ w, const int32_t* __restrict__ lut,
          int C, int D, int F, T* __restrict__ out) {
    const int g = blockIdx.z, c0 = blockIdx.y * TL_B, f0 = blockIdx.x * TL_B;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const T* W = w + (size_t)lut[g] * D * F;
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
            ws[kk][col] = (d < D && f < F) ? to_f(W[(size_t)d * F + f]) : 0.f;
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
            if (f < F) out[((size_t)g * C + c) * F + f] = from_f<T>(acc[r][q]);
        }
    }
}

template <typename T>
static int launch_gemv(const void* x, const void* w, const void* lut, int G, int C,
                       int D, int F, void* out, void* stream) {
    if (C > GV_MAXC) return (int)cudaErrorInvalidValue;
    const dim3 grid((F + GV_COLS - 1) / GV_COLS, G);
    gmm_gemv<T><<<grid, GV_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int32_t*>(lut),
        C, D, F, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_tiled(const void* x, const void* w, const void* lut, int G, int C,
                        int D, int F, void* out, void* stream) {
    const dim3 grid((F + TL_B - 1) / TL_B, (C + TL_B - 1) / TL_B, G);
    gmm_tiled<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int32_t*>(lut),
        C, D, F, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

// One C entry per body and element type: the Python wrapper picks the body
// (GEMV for C <= GV_MAXC) and counts each body's launches on its own.
#define SLOT_GMM_ENTRY(name, launcher, T)                                              \
    extern "C" int name(const void* x, const void* w, const void* lut, int G, int C,  \
                        int D, int F, void* out, void* stream) {                       \
        return launcher<T>(x, w, lut, G, C, D, F, out, stream);                        \
    }
SLOT_GMM_ENTRY(slot_gmm_gemv_bf16, launch_gemv, __nv_bfloat16)
SLOT_GMM_ENTRY(slot_gmm_gemv_f32, launch_gemv, float)
SLOT_GMM_ENTRY(slot_gmm_tiled_bf16, launch_tiled, __nv_bfloat16)
SLOT_GMM_ENTRY(slot_gmm_tiled_f32, launch_tiled, float)
