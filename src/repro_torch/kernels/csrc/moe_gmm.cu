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
//    [S+1, D/group, F]; each weight dequantizes to q*s + m in f32, rounded
//    as the plain version rounds it, before the product; out f32.
//
// Bound on this card: bytes at decode (G = top-k picks, C = 1: every weight
// byte is read once and used once; packed weights are what make the
// quantized bodies' bound 2x / 3.6x lower than bf16's), operations for large
// C at prefill. Two bodies per format, picked by C in the Python wrapper
// (kernels/moe_gmm.py):
//  * C <= 4, the GEMV body, built to stream the weights at HBM rate. Each
//    lane reads 16 bytes of a stored row at a time (8 bf16 or 4 f32; int8
//    and int4 lanes read 8 bytes, 8 int8 or 16 int4 weights, so the smaller
//    stores, which cost more ALU work per byte, still get enough lanes)
//    through the read-only path,
//    neighbouring lanes neighbouring chunks, the next rows' loads in flight
//    while the current ones are added. A block is 8 warps x 32 lanes: the
//    lanes cut the columns (a slab of 32 chunks), the warps a run of rows
//    each. The stored rows are cut into up to 8 splits, one block per
//    (slab, split, group), so the decode shapes fill the card. Each warp
//    stages the x values of its run in shared memory, 64 rows at a time,
//    so a run may be of any length and D has no limit; the run's first
//    loads are issued before its first rows of x are staged. A block
//    sums its warps in shared memory in warp order; the splits of a (slab,
//    group) tile form one thread block cluster, and each block of it sums
//    a share of the tile's outputs over the splits, in split order, reading
//    the other blocks' sums through distributed shared memory. No atomics
//    and no workspace: every launch gives the same bits, and row c of the
//    output does not depend on C. The plan (rows per warp, splits, the
//    vector flag) is the wrapper's, from D, F and the format alone; the
//    launcher only checks that the splits cover D. int4 loads the f16
//    scales and mins of its 8 columns once per group (16-byte loads) and
//    keeps them in registers while the run stays in the group. Widths
//    whose rows are not a multiple of a lane's bytes take the same kernel
//    with element loads (the ``VEC`` flag, set by the wrapper from F).
//    Bytes become floats through their bit patterns (``byte_as_float``),
//    not by conversion.
//  * C > 4, the tiled body: 64x64 output tiles, D in steps of 32 through
//    shared memory as f32 (int4: dequantized while staged, the group of
//    each row computed per row, since a group need not align with the
//    step), 4x4 outputs per thread. CUDA cores, no tensor cores yet.
// The LUT indirection is one load per block: rotation rewrites the LUT and
// the compute never changes, as in the reference.
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include "common.cuh"

using namespace repro;

constexpr int GV_WARPS = 8;      // runs of rows per block
constexpr int GV_LANES = 32;     // 16-byte column chunks per block
constexpr int GV_MAXC = 4;
constexpr int GV_XCHUNK = 64;    // rows of its run a warp stages x for at a time
constexpr int GV_MAXSPLITS = 8;  // splits of D: the blocks of one (portable) cluster
constexpr int GV_XS = GV_WARPS * GV_XCHUNK * 2;  // staged x values per row of x (XROWS <= 2)

// Byte k of ``word`` as an exact float, read through the f32 bit pattern of
// 2^23 + byte: one byte permute and one add, where an int-to-float
// conversion runs at a quarter of the add rate. ``bias`` is 2^23 for an
// unsigned byte, 2^23 + 128 for a signed byte whose word was XORed with
// 0x80808080.
__device__ __forceinline__ float byte_as_float(uint32_t word, int k, float bias) {
    return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + k)) - bias;
}
constexpr float U8_BIAS = 8388608.f, S8_BIAS = 8388736.f;

// Weight access of one slot, one struct per format: ``slot`` moves the
// pointers to slot s, ``row(d, f)`` is W[d][f] as f32 (the tiled body), and
// ``epilogue`` maps the accumulator of column f to the output. For the GEMV
// body: COLS columns per 16-byte chunk of a stored row, XROWS rows of x per
// stored row, ``chunk(r, c)`` the bytes (``Raw``) of chunk c of stored row r,
// ``begin``/``settle`` issue and convert the per-group data of a run's first
// row (int4's scales and mins; nothing for the others), ``step`` adds one
// stored row's products to a lane's accumulators (``xr``: the row's x
// values, GV_XS apart per row of x), ``step_scalar`` the same from element
// loads for widths the vector path cannot take.
template <typename T>
struct DenseW {
    using Raw = uint4;
    static constexpr int COLS = 16 / sizeof(T), XROWS = 1, UNROLL = 8;
    struct Cache {};
    const T* w;
    int F;
    __device__ void slot(int s, int D) { w += (size_t)s * D * F; }
    __device__ float row(int d, int f) const { return to_f(w[(size_t)d * F + f]); }
    __device__ float epilogue(float acc, int) const { return acc; }
    __device__ Raw chunk(int r, int c) const {
        return __ldg(reinterpret_cast<const uint4*>(w + (size_t)r * F) + c);
    }
    __device__ void begin(int, int, Cache&) const {}
    __device__ void settle(Cache&) const {}
    template <int C>
    __device__ void step(Raw raw, int, int, const float* xr, Cache&,
                         float (&acc)[C][COLS]) const {
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float xv = xr[c * GV_XS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) acc[c][j] = __fmaf_rn(xv, to_f(v[j]), acc[c][j]);
        }
    }
    template <int C>
    __device__ void step_scalar(int r, int f0, const float* xr, Cache&,
                                float (&acc)[C][COLS]) const {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const float wv = f0 + j < F ? row(r, f0 + j) : 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c][j] = __fmaf_rn(xr[c * GV_XS], wv, acc[c][j]);
        }
    }
};

struct Int8W {
    using Raw = uint2;    // 8 bytes: more lanes, and a whole run's loads in flight at once
    static constexpr int COLS = 8, XROWS = 1, UNROLL = 16;
    struct Cache {};
    const int8_t* w;
    const float* scale;   // [S+1, F]
    int F;
    __device__ void slot(int s, int D) {
        w += (size_t)s * D * F;
        scale += (size_t)s * F;
    }
    __device__ float row(int d, int f) const { return (float)w[(size_t)d * F + f]; }
    __device__ float epilogue(float acc, int f) const { return acc * scale[f]; }
    __device__ Raw chunk(int r, int c) const {
        return __ldg(reinterpret_cast<const uint2*>(w + (size_t)r * F) + c);
    }
    __device__ void begin(int, int, Cache&) const {}
    __device__ void settle(Cache&) const {}
    template <int C>
    __device__ void step(Raw raw, int, int, const float* xr, Cache&,
                         float (&acc)[C][COLS]) const {
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(&raw);
        float q[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) q[j] = byte_as_float(wd[j / 4] ^ 0x80808080u, j % 4, S8_BIAS);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float xv = xr[c * GV_XS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) acc[c][j] = __fmaf_rn(xv, q[j], acc[c][j]);
        }
    }
    template <int C>
    __device__ void step_scalar(int r, int f0, const float* xr, Cache&,
                                float (&acc)[C][COLS]) const {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const float wv = f0 + j < F ? row(r, f0 + j) : 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c][j] = __fmaf_rn(xr[c * GV_XS], wv, acc[c][j]);
        }
    }
};

struct Int4W {
    using Raw = uint2;    // 8 packed bytes: more lanes for the dequantization's ALU work
    static constexpr int COLS = 8, XROWS = 2, UNROLL = 8;
    struct Cache {        // the f16 scales and mins of a lane's 8 columns in one group
        uint4 raw[2];     // as loaded: scales, mins
        float s[COLS], m[COLS];
        int end = -1;     // the first packed row past the group
    };
    const uint8_t* w;     // [S+1, D/2, F]
    const __half* scale;  // [S+1, D/group, F]
    const __half* mn;
    int F, group;
    __device__ void slot(int s, int D) {
        w += (size_t)s * (D / 2) * F;
        scale += (size_t)s * (D / group) * F;
        mn += (size_t)s * (D / group) * F;
    }
    // q * s + m rounded as the plain version rounds it (q * s, then + m): q
    // has 4 bits and s 11, so q * s is exact in f32 and the fused form
    // gives the same bits
    static __device__ float deq(float q, float s, float m) { return __fmaf_rn(q, s, m); }
    __device__ float row(int d, int f) const {
        const uint8_t b = w[(size_t)(d / 2) * F + f];
        const size_t i = (size_t)(d / group) * F + f;
        return deq((float)((d & 1) ? (b >> 4) : (b & 0xF)), __half2float(scale[i]),
                   __half2float(mn[i]));
    }
    __device__ float epilogue(float acc, int) const { return acc; }
    __device__ Raw chunk(int p, int c) const {
        return __ldg(reinterpret_cast<const uint2*>(w + (size_t)p * F) + c);
    }
    // the group planes of packed row p's group: ``begin`` issues the 16-byte
    // loads, ``settle`` converts them once for the group's packed rows (a
    // run's rows only increase, so the group changes where ``end`` is passed)
    __device__ void begin(int p, int f0, Cache& k) const {
        const int grp = (2 * p) / group;
        k.end = (grp + 1) * (group / 2);
        k.raw[0] = __ldg(reinterpret_cast<const uint4*>(scale + (size_t)grp * F + f0));
        k.raw[1] = __ldg(reinterpret_cast<const uint4*>(mn + (size_t)grp * F + f0));
    }
    __device__ void settle(Cache& k) const {
        const __half* h = reinterpret_cast<const __half*>(k.raw);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            k.s[j] = __half2float(h[j]);
            k.m[j] = __half2float(h[COLS + j]);
        }
    }
    // group is even, so rows 2p and 2p+1 of a packed row share one scale and min
    template <int C>
    __device__ void step(Raw raw, int p, int f0, const float* xr, Cache& k,
                         float (&acc)[C][COLS]) const {
        if (p >= k.end) {
            begin(p, f0, k);
            settle(k);
        }
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const float qlo = byte_as_float(wd[j / 4] & 0x0F0F0F0Fu, j % 4, U8_BIAS);
            const float qhi = byte_as_float((wd[j / 4] >> 4) & 0x0F0F0F0Fu, j % 4, U8_BIAS);
            const float lo = deq(qlo, k.s[j], k.m[j]), hi = deq(qhi, k.s[j], k.m[j]);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                acc[c][j] = __fmaf_rn(xr[c * GV_XS], lo, acc[c][j]);
                acc[c][j] = __fmaf_rn(xr[c * GV_XS + 1], hi, acc[c][j]);
            }
        }
    }
    template <int C>
    __device__ void step_scalar(int p, int f0, const float* xr, Cache&,
                                float (&acc)[C][COLS]) const {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int f = f0 + j;
            const float lo = f < F ? row(2 * p, f) : 0.f, hi = f < F ? row(2 * p + 1, f) : 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                acc[c][j] = __fmaf_rn(xr[c * GV_XS], lo, acc[c][j]);
                acc[c][j] = __fmaf_rn(xr[c * GV_XS + 1], hi, acc[c][j]);
            }
        }
    }
};

// GEMV body: block (slab, split, group); see the note at the top. ``rw`` is
// the rows of a warp's run. The splits of a (slab, group) tile are one
// thread block cluster (gridDim.y blocks). A warp's x values live in its own
// GV_XCHUNK * 2 columns of ``xs``.
template <typename T, typename TO, typename W, int C, bool VEC>
__global__ void __launch_bounds__(GV_WARPS * GV_LANES)
gmm_gemv(const T* __restrict__ x, W wt, const int32_t* __restrict__ lut, int D, int F, int rw,
         TO* __restrict__ out) {
    constexpr int COLS = W::COLS, XR = W::XROWS, U = W::UNROLL, SLAB = GV_LANES * COLS;
    static_assert(XR <= 2 && GV_XCHUNK % U == 0, "a step's rows lie in one staged chunk");
    __shared__ float xs[C][GV_XS];
    __shared__ __align__(16) float red[GV_WARPS][SLAB];
    __shared__ float part[C * SLAB];                        // this split's sums
    const int slab = blockIdx.x, split = blockIdx.y, g = blockIdx.z, splits = gridDim.y;
    const int warp = threadIdx.x / GV_LANES, lane = threadIdx.x % GV_LANES;
    const int R = D / XR;                                   // stored rows
    const int r0 = split * GV_WARPS * rw, r1 = min(R, r0 + GV_WARPS * rw);
    const int rb = r0 + warp * rw, re = min(r1, rb + rw);   // this warp's run
    const int chunk = slab * GV_LANES + lane, f0 = chunk * COLS;
    const bool cols = f0 < F, active = cols && rb < re;
    float* xw = &xs[0][warp * GV_XCHUNK * 2];
    wt.slot(lut[g], D);

    // x of stored rows [r, r + GV_XCHUNK) of the run into the warp's columns
    // of xs, by the whole warp (every lane reaches it: the run is the warp's)
    auto stage = [&](int r) {
        const int n = min(GV_XCHUNK, re - r) * XR;
        const T* X = x + (size_t)g * C * D + (size_t)r * XR;
        __syncwarp();
        for (int i = lane; i < C * n; i += GV_LANES)
            xw[(i / n) * GV_XS + i % n] = to_f(X[(size_t)(i / n) * D + i % n]);
        __syncwarp();
    };

    float acc[C][COLS];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[c][j] = 0.f;
    // the run's first weights (and int4's first group planes) are in flight
    // while its first rows of x are staged
    typename W::Raw raw[U];
    typename W::Cache cache;
    if (VEC && active) {
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (rb + u < re) raw[u] = wt.chunk(rb + u, chunk);
        wt.begin(rb, f0, cache);
    }
    for (int cb = rb; cb < re; cb += GV_XCHUNK) {          // the run's staged chunks
        stage(cb);
        if (!cols) continue;
        const int ce = min(re, cb + GV_XCHUNK);
        if constexpr (VEC) {
            if (cb == rb) wt.settle(cache);
            for (int r = cb; r < ce; r += U) {              // rows r + U.. load while r.. add
                typename W::Raw next[U];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (r + U + u < re) next[u] = wt.chunk(r + U + u, chunk);
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (r + u < ce)
                        wt.template step<C>(raw[u], r + u, f0, xw + (r - cb + u) * XR, cache, acc);
#pragma unroll
                for (int u = 0; u < U; ++u) raw[u] = next[u];
            }
        } else {
            for (int r = cb; r < ce; ++r)
                wt.template step_scalar<C>(r, f0, xw + (r - cb) * XR, cache, acc);
        }
    }

    // the block's sum over its warps, in warp order
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < COLS; j += 4)
            *reinterpret_cast<float4*>(&red[warp][lane * COLS + j]) =
                make_float4(acc[c][j], acc[c][j + 1], acc[c][j + 2], acc[c][j + 3]);
        __syncthreads();
        for (int col = threadIdx.x; col < SLAB; col += blockDim.x) {
            float s = 0.f;
#pragma unroll
            for (int wv = 0; wv < GV_WARPS; ++wv) s += red[wv][col];
            part[c * SLAB + col] = s;
        }
        __syncthreads();
    }

    // the splits' sums, in split order, read from the cluster's shared
    // memory: block k of the cluster writes every splits-th output of the tile
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (splits > 1) cluster.sync();
    for (int i = split * blockDim.x + threadIdx.x; i < C * SLAB; i += blockDim.x * splits) {
        const int f = slab * SLAB + i % SLAB;
        if (f < F) {
            float s = part[i];
            if (splits > 1) {
                s = 0.f;
                for (int k = 0; k < splits; ++k) s += cluster.map_shared_rank(part, k)[i];
            }
            out[((size_t)g * C + i / SLAB) * F + f] = from_f<TO>(wt.epilogue(s, f));
        }
    }
    if (splits > 1) cluster.sync();                         // keep part alive for the readers
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

template <typename T, typename TO, typename W, int C, bool VEC>
static cudaError_t launch_gemv_body(dim3 grid, cudaStream_t st, const void* x, W wt,
                                    const void* lut, int D, int F, int rw, void* out) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(GV_WARPS * GV_LANES);
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = grid.y;                  // the splits of one tile
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, gmm_gemv<T, TO, W, C, VEC>, static_cast<const T*>(x), wt,
                              static_cast<const int32_t*>(lut), D, F, rw, static_cast<TO*>(out));
}

// GEMV launch: one kernel, the split sums included. The plan is the
// wrapper's: ``splits`` runs of GV_WARPS x ``rw`` stored rows must cover D's
// rows, none of them empty, in one cluster.
template <typename T, typename TO, typename W>
static int launch_gemv(W wt, const void* x, const void* lut, int G, int C, int D, int F, int rw,
                       int splits, int vec, void* out, void* stream) {
    const long R = D / W::XROWS, span = (long)GV_WARPS * rw;
    if (C < 1 || C > GV_MAXC || rw < 1 || splits < 1 || splits > GV_MAXSPLITS
        || splits * span < R || (splits - 1) * span >= R)
        return (int)cudaErrorInvalidValue;
    const int chunks = (F + W::COLS - 1) / W::COLS;
    const dim3 grid((chunks + GV_LANES - 1) / GV_LANES, splits, G);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
#define GV_CASE(CC)                                                                          \
    case CC:                                                                                 \
        err = vec ? launch_gemv_body<T, TO, W, CC, true>(grid, st, x, wt, lut, D, F, rw, out) \
                  : launch_gemv_body<T, TO, W, CC, false>(grid, st, x, wt, lut, D, F, rw, out); \
        break;
    switch (C) { GV_CASE(1) GV_CASE(2) GV_CASE(3) GV_CASE(4) }
#undef GV_CASE
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename T, typename TO, typename W>
static int launch_tiled(W wt, const void* x, const void* lut, int G, int C, int D, int F,
                        void* out, void* stream) {
    const dim3 grid((F + TL_B - 1) / TL_B, (C + TL_B - 1) / TL_B, G);
    gmm_tiled<T, TO, W><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), wt, static_cast<const int32_t*>(lut), C, D, F,
        static_cast<TO*>(out));
    return (int)cudaGetLastError();
}

// One C entry per body, weight format and activation type: the Python
// wrapper picks the body (GEMV for C <= GV_MAXC, with its plan: rows per
// warp, splits, the vector flag) and counts each body's launches on its own.
#define SLOT_GMM_ENTRIES(T, sfx)                                                         \
    extern "C" int slot_gmm_gemv_##sfx(const void* x, const void* w, const void* lut,   \
                                        int G, int C, int D, int F, int rw, int splits,   \
                                        int vec, void* out, void* stream) {              \
        const DenseW<T> wt{static_cast<const T*>(w), F};                                 \
        return launch_gemv<T, T>(wt, x, lut, G, C, D, F, rw, splits, vec, out, stream);  \
    }                                                                                    \
    extern "C" int slot_gmm_tiled_##sfx(const void* x, const void* w, const void* lut,  \
                                         int G, int C, int D, int F, void* out,          \
                                         void* stream) {                                 \
        const DenseW<T> wt{static_cast<const T*>(w), F};                                 \
        return launch_tiled<T, T>(wt, x, lut, G, C, D, F, out, stream);                  \
    }
SLOT_GMM_ENTRIES(__nv_bfloat16, bf16)
SLOT_GMM_ENTRIES(float, f32)

#define SLOT_GMM_INT8_ENTRIES(T, sfx)                                                    \
    extern "C" int slot_gmm_int8_gemv_##sfx(const void* x, const void* w,               \
                                             const void* scale, const void* lut, int G,  \
                                             int C, int D, int F, int rw, int splits,    \
                                             int vec, void* out, void* stream) {         \
        const Int8W wt{static_cast<const int8_t*>(w), static_cast<const float*>(scale), F}; \
        return launch_gemv<T, float>(wt, x, lut, G, C, D, F, rw, splits, vec, out, stream); \
    }                                                                                    \
    extern "C" int slot_gmm_int8_tiled_##sfx(const void* x, const void* w,              \
                                              const void* scale, const void* lut, int G, \
                                              int C, int D, int F, void* out,            \
                                              void* stream) {                            \
        const Int8W wt{static_cast<const int8_t*>(w), static_cast<const float*>(scale), F}; \
        return launch_tiled<T, float>(wt, x, lut, G, C, D, F, out, stream);              \
    }
SLOT_GMM_INT8_ENTRIES(__nv_bfloat16, bf16)
SLOT_GMM_INT8_ENTRIES(float, f32)

#define INT4_STORE                                                                       \
    if (group < 2 || group % 2 || D % group) return (int)cudaErrorInvalidValue;          \
    const Int4W wt{static_cast<const uint8_t*>(w), static_cast<const __half*>(scale),    \
                   static_cast<const __half*>(mn), F, group};
#define SLOT_GMM_INT4_ENTRIES(T, sfx)                                                    \
    extern "C" int slot_gmm_int4_gemv_##sfx(const void* x, const void* w,               \
                                             const void* scale, const void* mn,          \
                                             const void* lut, int G, int C, int D, int F, \
                                             int group, int rw, int splits, int vec,     \
                                             void* out, void* stream) {                  \
        INT4_STORE                                                                       \
        return launch_gemv<T, float>(wt, x, lut, G, C, D, F, rw, splits, vec, out, stream); \
    }                                                                                    \
    extern "C" int slot_gmm_int4_tiled_##sfx(const void* x, const void* w,              \
                                              const void* scale, const void* mn,         \
                                              const void* lut, int G, int C, int D,      \
                                              int F, int group, void* out,               \
                                              void* stream) {                            \
        INT4_STORE                                                                       \
        return launch_tiled<T, float>(wt, x, lut, G, C, D, F, out, stream);              \
    }
SLOT_GMM_INT4_ENTRIES(__nv_bfloat16, bf16)
SLOT_GMM_INT4_ENTRIES(float, f32)
