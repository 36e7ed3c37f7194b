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
//  * C > 4, the tiled body (prefill: a prompt's picks grouped by slot; at
//    the main path's shape it streams 302 MB of bf16 weights, so bytes
//    bound it too). With bf16 x, on tensor cores (``tiled::gmm_tc``):
//    mma.sync m16n8k16 with f32 sums, blocks of 64 rows of x by 64 or 128
//    columns, D in steps of 32 or 64 through a 3-stage cp.async ring; int8
//    and int4 bytes become exact bf16 integers in shared memory, int8's
//    scale multiplies the accumulator at the store and int4's group affine
//    is folded in per group (see the note at ``gmm_tc``). f32 x, and shapes
//    whose rows are not whole 16-byte copies or whose int4 group is not
//    32, 64 or 128, take the CUDA-core body (``gmm_tiled``): 64x64 output
//    tiles, D in steps of 32 through shared memory as f32 (int4 dequantized
//    while staged), 4x4 outputs per thread. The plan (tensor cores or not,
//    the tile) is the wrapper's, from D, F and the types alone.
//  * the ragged entry of the tiled body (a prefill chunk's MoE half inside a
//    CUDA graph): x [N, D] holds the picks' rows sorted by slot and
//    ``offsets`` [S1 + 1] each slot's first row, both made on the device
//    (a stable argsort of the T*k slot ids and a search of its sorted keys),
//    so no count reaches the host and one launch serves any routing. The
//    grid takes the most 64-row tiles N rows can make over S1 slots; each
//    block finds its slot and tile from the offsets (``ragged_tile``), tiles
//    past the last one return at once, and MISS tiles write zeros without
//    reading weights. The body past that is the tiled body's, so a row gives
//    the same bits grouped or ragged.
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

// ---------------------------------------------------------------------------
// Tiled body on CUDA cores: f32 x, and shapes the tensor-core body does not
// take (rows that are not whole 16-byte copies, int4 groups that are not a
// multiple of 16)
// ---------------------------------------------------------------------------
constexpr int TL_B = 64;   // output tile rows and columns
constexpr int TL_K = 32;   // reduction step

// The ragged entry's tile map. x holds N rows sorted by slot, rows
// offsets[s] .. offsets[s + 1] of slot s (S1 slots), every count on the
// device. Tile t of the grid is the t-th 64-row
// tile in slot order: the first warp scans the per-slot tile counts 32
// slots at a time (shuffles, no shared memory) and the block reads its slot
// and its tile within the slot from shared memory. Returns false for the
// whole block past the last tile. Every thread of the block calls it.
constexpr int RG_B = 64;   // rows per tile of both tiled bodies
__device__ bool ragged_tile(const int32_t* __restrict__ offsets, int S1, int t, int& slot,
                            int& tile) {
    __shared__ int found[2];
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int base = 0, hit_slot = -1, hit_tile = 0;
        for (int s0 = 0; s0 < S1; s0 += 32) {
            const int s = s0 + lane;
            const int n = s < S1 ? (offsets[s + 1] - offsets[s] + RG_B - 1) / RG_B : 0;
            int inc = n;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, inc, o);
                if (lane >= o) inc += y;
            }
            const int first = base + inc - n;
            const unsigned hit = __ballot_sync(0xffffffffu, t >= first && t < first + n);
            if (hit) {                                    // the same for every lane
                const int src = __ffs(hit) - 1;
                hit_slot = s0 + src;
                hit_tile = t - __shfl_sync(0xffffffffu, first, src);
                break;
            }
            base += __shfl_sync(0xffffffffu, inc, 31);
        }
        if (lane == 0) {
            found[0] = hit_slot;
            found[1] = hit_tile;
        }
    }
    __syncthreads();
    slot = found[0];
    tile = found[1];
    return slot >= 0;
}

// The rows a block of either tiled body computes: ``X`` and ``out`` rows
// start at ``row0``, the group holds ``C`` rows of which the block takes
// ``c0 .. c0 + 63``, its weights are slot ``slot``. The grouped entries take
// group blockIdx.z of [G, C, D]; the ragged entry maps tile blockIdx.y to
// its slot (``ragged_tile``). ``skip``: a tile of slot ``miss`` (the MISS
// row; -1 for none), whose rows are zeros.
struct Rows {
    size_t row0;
    int C, c0, slot;
    bool skip;
};

__device__ bool block_rows(const int32_t* __restrict__ lut, const int32_t* __restrict__ offsets,
                           int S1, int miss, int C, Rows& r) {
    if (offsets == nullptr) {
        const int g = blockIdx.z;
        r = Rows{(size_t)g * C, C, (int)blockIdx.y * RG_B, lut[g], false};
        return true;
    }
    int slot, tile;
    if (!ragged_tile(offsets, S1, blockIdx.y, slot, tile)) return false;
    const int begin = offsets[slot];
    r = Rows{(size_t)begin, offsets[slot + 1] - begin, tile * RG_B, slot, slot == miss};
    return true;
}

// A MISS tile of the ragged entry: its rows' outputs are zeros (their
// weight is dropped), its weights are never read.
template <typename TO>
__device__ void zero_rows(TO* __restrict__ out, const Rows& r, int f0, int bn, int F) {
    for (int i = threadIdx.x; i < RG_B * bn; i += blockDim.x) {
        const int c = r.c0 + i / bn, f = f0 + i % bn;
        if (c < r.C && f < F) out[(r.row0 + c) * F + f] = from_f<TO>(0.f);
    }
}

template <typename T, typename TO, typename W>
__global__ void __launch_bounds__(256)
gmm_tiled(const T* __restrict__ x, W wt, const int32_t* __restrict__ lut,
          const int32_t* __restrict__ offsets, int S1, int miss, int C_all, int D, int F,
          TO* __restrict__ out) {
    Rows rr;
    if (!block_rows(lut, offsets, S1, miss, C_all, rr)) return;
    const int f0 = blockIdx.x * TL_B;
    if (rr.skip) {
        zero_rows(out, rr, f0, TL_B, F);
        return;
    }
    const int C = rr.C, c0 = rr.c0;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    wt.slot(rr.slot, D);
    const T* X = x + rr.row0 * D;
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
            if (f < F) out[(rr.row0 + c) * F + f] = from_f<TO>(wt.epilogue(acc[r][q], f));
        }
    }
}

// ---------------------------------------------------------------------------
// Tiled body on tensor cores (bf16 x; bf16, int8 and int4 stores)
// ---------------------------------------------------------------------------
namespace tiled {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;          // rows of x per block: C in steps of 64
constexpr int THREADS = 256;    // 8 warps: 2 along M (32 rows each) x 4 along N
constexpr int STAGES = 3;       // the cp.async ring
constexpr int PAD = 8;          // bf16 elements (16 bytes) of padding per shared row
enum Fmt { BF16 = 0, INT8 = 1, INT4 = 2 };

struct Args {
    const bf16* x;              // [G, C, D]
    const void* w;              // the store: bf16 / int8 [S+1, D, F], u8 [S+1, D/2, F]
    const float* scale8;        // int8: [S+1, F]
    const __half* s4;           // int4: [S+1, D/group, F]
    const __half* m4;
    const int32_t* lut;         // grouped: [G]
    const int32_t* offsets;     // ragged: [S1 + 1] row offsets of the slots (else null)
    void* out;                  // [G, C, F] (ragged: [N, F]): bf16 for a bf16 store, f32 otherwise
    int C, D, F, group;         // ragged: C is N, the rows of x
    int S1, miss, tiles;        // ragged: rows of the store, the MISS row (-1: none), M tiles
};

// Bytes k and k + 1 of ``word`` as packed int4: their low nibbles as a bf16
// pair in ``lo``, their high nibbles in ``hi``, exact. Each nibble q goes
// into the mantissa of bf16 128 (0x4300 | q is 128 + q), and 128 comes off
// in one bf16 subtraction per pair.
__device__ __forceinline__ void nibbles_bf16(uint32_t word, int k, uint32_t& lo, uint32_t& hi) {
    const uint32_t t = __byte_perm(word, 0u, 0x4040 | k | ((k + 1) << 8));
    const uint32_t l = (t & 0x000F000Fu) | 0x43004300u, h = ((t >> 4) & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 c128 = __floats2bfloat162_rn(128.f, 128.f);
    const __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), c128);
    const __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), c128);
    lo = *reinterpret_cast<const uint32_t*>(&lv);
    hi = *reinterpret_cast<const uint32_t*>(&hv);
}

// shared layout of one stage and of the whole ring, in bytes
template <int FMT, int BK, int BN>
struct Layout {
    static constexpr int LDX = BK + PAD, LDW = BN + PAD;
    static constexpr int X = BM * LDX * 2;                              // x tile, bf16
    static constexpr int W = FMT == BF16 ? BK * LDW * 2                 // weight tile as stored
                           : FMT == INT8 ? BK * BN : BK / 2 * BN;
    static constexpr int NGS_MAX = BK / 32;                             // int4 groups per step
    static constexpr int P = FMT == INT4 ? 2 * NGS_MAX * BN * 2 : 0;    // int4 scale/min rows
    static constexpr int STAGE = X + W + P;
    static constexpr int WB = FMT == BF16 ? 0 : BK * LDW * 2;           // converted bf16 weights
    static constexpr int TOTAL = STAGES * STAGE + WB;
};

// Block (n tile, m tile, group). Per D step of BK: x [BM, BK] and the
// weights [BK, BN] (bf16 as stored; int8 and int4 as raw bytes, converted
// to exact bf16 integers in a second shared tile) arrive by cp.async three
// steps deep; each warp runs mma.sync m16n8k16 on its 32 x BN/4 tile, x as
// the row-major A operand (ldmatrix), the [BK, BN] row-major weights as the
// col-major B operand (ldmatrix.trans). The sum over D runs k16 slice by
// k16 slice in one order whatever C and G, and an output element depends
// only on its own row of x, so row c of the output does not depend on C.
// int8: the f32 sums of x . q take the channel's scale at the store, as in
// the GEMV body. int4 (q * s + m is an f32 value, so it is never rounded
// to bf16): the k16 slices of one group sum x . q exactly on the tensor
// cores into a second accumulator, folded in once the group is done as
// acc += s * (x . q) + m * (sum of x over the group), the group's sum of x
// taken on the tensor cores too, as x . 1. The group (32, 64 or 128) is a
// template parameter, so it divides BK or BK divides it.
template <int FMT, int BK, int BN, int GROUP>
__global__ void __launch_bounds__(THREADS)
gmm_tc(Args a) {
    using L = Layout<FMT, BK, BN>;
    constexpr int LDX = L::LDX, LDW = L::LDW, WN = BN / 4, NT = WN / 8, KS = BK / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    Rows rr;
    if (!block_rows(a.lut, a.offsets, a.S1, a.miss, a.C, rr)) return;
    const int f0 = blockIdx.x * BN;
    const int D = a.D, F = a.F;
    if (rr.skip) {
        if constexpr (FMT == BF16) zero_rows(static_cast<bf16*>(a.out), rr, f0, BN, F);
        else zero_rows(static_cast<float*>(a.out), rr, f0, BN, F);
        return;
    }
    const int C = rr.C, c0 = rr.c0, slot = rr.slot;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
    const int wm = warp / 4, wn = warp % 4;
    const bf16* X = a.x + rr.row0 * D;
    const int nk = (D + BK - 1) / BK;
    // int4: columns of one group segment within a step, and segments per step
    constexpr int SEG = FMT == INT4 ? (GROUP < BK ? GROUP : BK) : BK, NSEG = BK / SEG;

    auto stage_ptr = [&](int st) { return smem + st * L::STAGE; };
    auto load_stage = [&](int st, int kt) {
        unsigned char* base = stage_ptr(st);
        const int k0 = kt * BK;
        bf16* xs = reinterpret_cast<bf16*>(base);
        for (int i = tid; i < BM * (BK / 8); i += THREADS) {          // x: 8 columns a copy
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            const bool ok = c0 + r < C && k0 + c < D;
            cp_async16(xs + r * LDX + c, X + (ok ? (size_t)(c0 + r) * D + k0 + c : 0), ok);
        }
        unsigned char* ws = base + L::X;
        if constexpr (FMT == BF16) {
            const bf16* W = static_cast<const bf16*>(a.w) + (size_t)slot * D * F;
            for (int i = tid; i < BK * (BN / 8); i += THREADS) {
                const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
                const bool ok = k0 + r < D && f0 + c < F;
                cp_async16(reinterpret_cast<bf16*>(ws) + r * LDW + c,
                           W + (ok ? (size_t)(k0 + r) * F + f0 + c : 0), ok);
            }
        } else {
            // raw bytes: int8 rows of BN bytes, int4 packed rows (2 rows of D each)
            const int rows = FMT == INT8 ? BK : BK / 2, r0 = FMT == INT8 ? k0 : k0 / 2;
            const int R = FMT == INT8 ? D : D / 2;
            const uint8_t* W = static_cast<const uint8_t*>(a.w) + (size_t)slot * R * F;
            for (int i = tid; i < rows * (BN / 16); i += THREADS) {
                const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
                const bool ok = r0 + r < R && f0 + c < F;
                cp_async16(ws + r * BN + c, W + (ok ? (size_t)(r0 + r) * F + f0 + c : 0), ok);
            }
            if constexpr (FMT == INT4) {             // the scale and min rows of the step's groups
                __half* ps = reinterpret_cast<__half*>(base + L::X + L::W);
                const int NG = D / GROUP, g0 = k0 / GROUP;
                const size_t off = (size_t)slot * NG * F;
                for (int i = tid; i < 2 * NSEG * (BN / 8); i += THREADS) {
                    const int plane = i / (NSEG * (BN / 8)), j = i % (NSEG * (BN / 8));
                    const int r = j / (BN / 8), c = (j % (BN / 8)) * 8, gi = g0 + r;
                    const bool ok = gi < NG && f0 + c < F;
                    const __half* src = plane ? a.m4 : a.s4;
                    cp_async16(ps + (plane * L::NGS_MAX + r) * BN + c,
                               src + (ok ? off + (size_t)gi * F + f0 + c : 0), ok);
                }
            }
        }
    };

    // int4: the group's x . q and sum of x (x . 1, all columns alike) so far
    float acc[2][NT][4], part[2][NT][4], xsum[2][4];
    constexpr uint32_t ONES = 0x3F803F80u;            // two bf16 1.0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    if constexpr (FMT == INT4) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) xsum[i][0] = xsum[i][1] = xsum[i][2] = xsum[i][3] = 0.f;
    }
    bf16* wb = reinterpret_cast<bf16*>(smem + STAGES * L::STAGE);     // converted weights
    const bool rows_live[2] = {c0 + wm * 32 < C, c0 + wm * 32 + 16 < C};
    // int4: a finished group's x . q and sum of x wait in ``part`` and
    // ``xsum`` with its scales and mins in registers, and are folded in as
    // the next group starts (or at the end), so the fold does not wait on
    // the products just issued
    __half2 pend_s[NT], pend_m[NT];
    bool pending = false;
    auto fold = [&]() {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float2 sv = __half22float2(pend_s[n]), mv = __half22float2(pend_m[n]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float sc = e & 1 ? sv.y : sv.x, m = e & 1 ? mv.y : mv.x;
                    acc[i][n][e] = __fmaf_rn(sc, part[i][n][e], acc[i][n][e]);
                    acc[i][n][e] = __fmaf_rn(m, xsum[i][e & 2], acc[i][n][e]);
                    part[i][n][e] = 0.f;
                }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) xsum[i][0] = xsum[i][1] = xsum[i][2] = xsum[i][3] = 0.f;
        pending = false;
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();                  // step kt has landed
        __syncthreads();                              // and every warp is done with step kt - 1
        if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
        cp_async_commit();
        const unsigned char* base = stage_ptr(kt % STAGES);
        const bf16* xs = reinterpret_cast<const bf16*>(base);
        const int k0 = kt * BK;
        if constexpr (FMT != BF16) {
            // raw bytes -> exact bf16 integers (int8: |q| <= 128; int4: 0..15)
            const uint8_t* raw = base + L::X;
            if constexpr (FMT == INT8) {
                for (int i = tid; i < BK * (BN / 16); i += THREADS) {
                    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
                    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + c);
                    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
                    uint32_t o[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const uint32_t word = wd[j / 2] ^ 0x80808080u;
                        o[j] = pack_bf16(byte_as_float(word, (j % 2) * 2, S8_BIAS),
                                         byte_as_float(word, (j % 2) * 2 + 1, S8_BIAS));
                    }
                    uint4* dst = reinterpret_cast<uint4*>(wb + r * LDW + c);
                    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
                    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
                }
            } else {
                for (int i = tid; i < BK / 2 * (BN / 16); i += THREADS) {
                    const int p = i / (BN / 16), c = (i % (BN / 16)) * 16;
                    const uint4 v = *reinterpret_cast<const uint4*>(raw + p * BN + c);
                    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
                    uint32_t lo[8], hi[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) nibbles_bf16(wd[j / 2], (j % 2) * 2, lo[j], hi[j]);
                    uint4* d0 = reinterpret_cast<uint4*>(wb + (2 * p) * LDW + c);
                    uint4* d1 = reinterpret_cast<uint4*>(wb + (2 * p + 1) * LDW + c);
                    d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
                    d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
                    d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
                    d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
                }
            }
            __syncthreads();
        }
        const bf16* wt = FMT == BF16 ? reinterpret_cast<const bf16*>(base + L::X) : wb;
        const __half* ps = reinterpret_cast<const __half*>(base + L::X + L::W);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            if (k0 + kk * 16 >= D) break;
            if constexpr (FMT == INT4)
                if (pending) fold();                        // the last group, before the next
            uint32_t af[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                if (rows_live[i]) {
                    ldmatrix_x4(af[i], xs + (wm * 32 + i * 16 + (lane & 15)) * LDX + kk * 16
                                           + (lane >> 4) * 8);
                }
#pragma unroll
            for (int nn = 0; nn < WN / 16; ++nn) {
                uint32_t bq[4];
                ldmatrix_x4_trans(bq, wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW
                                          + wn * WN + nn * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    if (!rows_live[i]) continue;
                    if constexpr (FMT == INT4) {
                        mma(part[i][2 * nn], af[i], bq[0], bq[1]);
                        mma(part[i][2 * nn + 1], af[i], bq[2], bq[3]);
                    } else {
                        mma(acc[i][2 * nn], af[i], bq[0], bq[1]);
                        mma(acc[i][2 * nn + 1], af[i], bq[2], bq[3]);
                    }
                }
            }
            if constexpr (FMT == INT4) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    if (rows_live[i]) mma(xsum[i], af[i], ONES, ONES);
                if ((k0 + kk * 16 + 16) % GROUP == 0) {         // the group ends: keep its planes
                    const int jj = kk * 16 / SEG;
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        const int col = wn * WN + n * 8 + 2 * t4;
                        pend_s[n] = *reinterpret_cast<const __half2*>(ps + jj * BN + col);
                        pend_m[n] = *reinterpret_cast<const __half2*>(ps + (L::NGS_MAX + jj) * BN + col);
                    }
                    pending = true;
                }
            }
        }
    }
    if constexpr (FMT == INT4)
        if (pending) fold();
    cp_async_wait<0>();

    // the store: c0/c1 are row gq, c2/c3 row gq + 8; columns 2 * t4 + {0, 1}
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = c0 + wm * 32 + i * 16 + gq + (e >> 1) * 8;
                const int f = f0 + wn * WN + n * 8 + 2 * t4 + (e & 1);
                if (c >= C || f >= F) continue;
                const size_t o = (rr.row0 + c) * F + f;
                if constexpr (FMT == BF16) static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(acc[i][n][e]);
                else if constexpr (FMT == INT8)
                    static_cast<float*>(a.out)[o] = acc[i][n][e] * a.scale8[(size_t)slot * F + f];
                else static_cast<float*>(a.out)[o] = acc[i][n][e];
            }
}

// The plan's checks for the tensor-core body: whole 16-byte copies of x rows
// (D % 8), of the stored rows (F x element bytes % 16) and of int4's planes,
// and an int4 group of 32, 64 or 128 (a template parameter: the fold's
// place in the k16 loop is then known at compile time).
template <int FMT>
static bool fits(int D, int F, int group, int bk) {
    if (D % 8) return false;
    if (FMT == BF16) return F % 8 == 0;
    if (FMT == INT8) return F % 16 == 0;
    return F % 16 == 0 && (group == 32 || group == 64 || group == 128) && D % group == 0;
}

template <int FMT, int BK, int BN, int GROUP>
static int launch_body(const Args& a, int G, cudaStream_t st) {
    using L = Layout<FMT, BK, BN>;
    cudaError_t err = cudaFuncSetAttribute(gmm_tc<FMT, BK, BN, GROUP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.F + BN - 1) / BN, a.offsets ? a.tiles : (a.C + BM - 1) / BM,
                    a.offsets ? 1 : G);
    gmm_tc<FMT, BK, BN, GROUP><<<grid, THREADS, L::TOTAL, st>>>(a);
    return (int)cudaGetLastError();
}

template <int FMT, int GROUP>
static int launch_tile(const Args& a, int G, int bk, int bn, cudaStream_t st) {
    if (bk == 32 && bn == 64) return launch_body<FMT, 32, 64, GROUP>(a, G, st);
    if (bk == 32 && bn == 128) return launch_body<FMT, 32, 128, GROUP>(a, G, st);
    if (bk == 64 && bn == 64) return launch_body<FMT, 64, 64, GROUP>(a, G, st);
    if (bk == 64 && bn == 128) return launch_body<FMT, 64, 128, GROUP>(a, G, st);
    return (int)cudaErrorInvalidValue;
}

template <int FMT>
static int launch(const Args& a, int G, int bk, int bn, cudaStream_t st) {
    if (!fits<FMT>(a.D, a.F, a.group, bk)) return (int)cudaErrorInvalidValue;
    if constexpr (FMT != INT4) {
        return launch_tile<FMT, 0>(a, G, bk, bn, st);
    } else {
        switch (a.group) {
            case 32: return launch_tile<FMT, 32>(a, G, bk, bn, st);
            case 64: return launch_tile<FMT, 64>(a, G, bk, bn, st);
            case 128: return launch_tile<FMT, 128>(a, G, bk, bn, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
}

}  // namespace tiled

// The ragged tile map hands both tiled bodies RG_B-row tiles: it must be the
// row tile of each, or rows would land in another slot's tile.
static_assert(RG_B == tiled::BM && RG_B == TL_B, "ragged tiles are the tiled bodies' row tiles");

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

// Tiled launch: the tensor-core body where the wrapper's plan asks for it
// (``tc``, bf16 x only, with its D step ``bk`` and N tile ``bn``), the
// CUDA-core body otherwise. ``w``, ``p0``, ``p1``: the store and its planes
// (int8: scale; int4: scale, min).
//
// Ragged (``offsets`` not null, G = 1, C = N): x [N, D] holds the rows
// sorted by slot, ``offsets`` [S1 + 1] the slots' first rows, all on the
// device, so the launch needs no count from the host: the grid takes the
// most 64-row tiles N rows can make over S1 slots (ceil(N / 64) + min(S1,
// N)) and the blocks past the last tile return at once; the rows of slot
// ``miss`` (the MISS row, -1 for a store without one) come out as zeros.
template <int FMT, typename T, typename TO, typename W>
static int launch_tiled(W wt, const void* x, const void* w, const void* p0, const void* p1,
                        const void* lut, const void* offsets, int S1, int miss, int G, int C,
                        int D, int F, int group, int tc, int bk, int bn, void* out,
                        void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* offs = static_cast<const int32_t*>(offsets);
    const int tiles = offs ? (C + RG_B - 1) / RG_B + (S1 < C ? S1 : C) : 0;
    if (offs && (S1 < 1 || G != 1)) return (int)cudaErrorInvalidValue;
    if (tc) {
        if constexpr (sizeof(T) == 2) {
            const tiled::Args a{static_cast<const __nv_bfloat16*>(x), w,
                                static_cast<const float*>(p0), static_cast<const __half*>(p0),
                                static_cast<const __half*>(p1), static_cast<const int32_t*>(lut),
                                offs, out, C, D, F, group, S1, miss, tiles};
            return tiled::launch<FMT>(a, G, bk, bn, st);
        }
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((F + TL_B - 1) / TL_B, offs ? tiles : (C + TL_B - 1) / TL_B, offs ? 1 : G);
    gmm_tiled<T, TO, W><<<grid, 256, 0, st>>>(static_cast<const T*>(x), wt,
                                               static_cast<const int32_t*>(lut), offs, S1, miss,
                                               C, D, F, static_cast<TO*>(out));
    return (int)cudaGetLastError();
}

// One C entry per body, weight format and activation type: the Python
// wrapper picks the body (GEMV for C <= GV_MAXC, with its plan: rows per
// warp, splits, the vector flag; the tiled body with its plan: tensor cores
// or not, D step, N tile) and counts each body's launches on its own.
#define SLOT_GMM_ENTRIES(T, sfx)                                                         \
    extern "C" int slot_gmm_gemv_##sfx(const void* x, const void* w, const void* lut,   \
                                        int G, int C, int D, int F, int rw, int splits,   \
                                        int vec, void* out, void* stream) {              \
        const DenseW<T> wt{static_cast<const T*>(w), F};                                 \
        return launch_gemv<T, T>(wt, x, lut, G, C, D, F, rw, splits, vec, out, stream);  \
    }                                                                                    \
    extern "C" int slot_gmm_tiled_##sfx(const void* x, const void* w, const void* lut,  \
                                         int G, int C, int D, int F, int tc, int bk,     \
                                         int bn, void* out, void* stream) {              \
        const DenseW<T> wt{static_cast<const T*>(w), F};                                 \
        return launch_tiled<tiled::BF16, T, T>(wt, x, w, nullptr, nullptr, lut, nullptr, \
                                               0, -1, G, C, D, F, 0, tc, bk, bn, out,    \
                                               stream);                                  \
    }                                                                                    \
    extern "C" int slot_gmm_ragged_##sfx(const void* x, const void* w, const void* offsets, \
                                          int N, int S1, int miss, int D, int F, int tc, \
                                          int bk, int bn, void* out, void* stream) {     \
        const DenseW<T> wt{static_cast<const T*>(w), F};                                 \
        return launch_tiled<tiled::BF16, T, T>(wt, x, w, nullptr, nullptr, nullptr,      \
                                               offsets, S1, miss, 1, N, D, F, 0, tc, bk, \
                                               bn, out, stream);                         \
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
                                              int C, int D, int F, int tc, int bk, int bn, \
                                              void* out, void* stream) {                 \
        const Int8W wt{static_cast<const int8_t*>(w), static_cast<const float*>(scale), F}; \
        return launch_tiled<tiled::INT8, T, float>(wt, x, w, scale, nullptr, lut,        \
                                                   nullptr, 0, -1, G, C, D, F, 0, tc, bk, \
                                                   bn, out, stream);                     \
    }                                                                                    \
    extern "C" int slot_gmm_int8_ragged_##sfx(const void* x, const void* w,             \
                                               const void* scale, const void* offsets,   \
                                               int N, int S1, int miss, int D, int F,    \
                                               int tc, int bk, int bn, void* out,        \
                                               void* stream) {                           \
        const Int8W wt{static_cast<const int8_t*>(w), static_cast<const float*>(scale), F}; \
        return launch_tiled<tiled::INT8, T, float>(wt, x, w, scale, nullptr, nullptr,    \
                                                   offsets, S1, miss, 1, N, D, F, 0, tc, \
                                                   bk, bn, out, stream);                 \
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
                                              int F, int group, int tc, int bk, int bn,  \
                                              void* out, void* stream) {                 \
        INT4_STORE                                                                       \
        return launch_tiled<tiled::INT4, T, float>(wt, x, w, scale, mn, lut, nullptr, 0, \
                                                   -1, G, C, D, F, group, tc, bk, bn, out, \
                                                   stream);                              \
    }                                                                                    \
    extern "C" int slot_gmm_int4_ragged_##sfx(const void* x, const void* w,             \
                                               const void* scale, const void* mn,        \
                                               const void* offsets, int N, int S1,       \
                                               int miss, int D, int F, int group, int tc, \
                                               int bk, int bn, void* out, void* stream) { \
        INT4_STORE                                                                       \
        return launch_tiled<tiled::INT4, T, float>(wt, x, w, scale, mn, nullptr, offsets, \
                                                   S1, miss, 1, N, D, F, group, tc, bk,  \
                                                   bn, out, stream);                     \
    }
SLOT_GMM_INT4_ENTRIES(__nv_bfloat16, bf16)
SLOT_GMM_INT4_ENTRIES(float, f32)
