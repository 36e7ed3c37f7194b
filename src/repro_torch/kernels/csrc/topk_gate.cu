// K3, the router gate, in two entries that share one selection routine:
//
//  * topk_gate_f32: logits [T, E] f32 in, the counterpart of the Pallas
//    kernel repro/kernels/topk_gate.py:_topk_kernel (pallas_call at
//    topk_gate.py:93), which takes logits;
//  * router_topk_{bf16,f32}: the MoE input h2 [T, D] (bf16 or f32) and the
//    f32 router [D, E] in, so the router GEMM of
//    repro/models/moe.py:router_logits runs in the same launch (the
//    reference's main path runs the two at repro/models/transformer.py:280).
//    The logits stay in registers and shared memory; they are never written
//    to device memory.
//
// Both give ids int32 [T, k] and weights f32 [T, k]: softmax over the row,
// the top k PROBABILITIES with the lowest index first among equals (two
// distinct logits can round to one probability; the reference then takes
// the lower index), then the optional renormalization.
//
// Bound on this card. Decode (T = 1, D 2048, E 128): bytes, the 1 MiB f32
// router (0.31 us at 3.35 TB/s); what sets the time is latency: the launch,
// pulling 1 MiB into the SMs, one cluster barrier, the selection. Prefill
// (T = 512): f32 operations, 2 T D E = 268 MFLOP (4.0 us at the 67 TFLOP/s
// f32 peak outside the tensor cores). The products stay f32 on CUDA cores,
// as the reference's router: tf32 or bf16 tensor cores would change which
// experts win.
//
// Selection (select_warp, both entries): one warp a row. Lane l holds
// entries l, l + 32, ... in registers (E <= 256; a shared-memory row above
// that). The probabilities are kept as order-preserving unsigned bits, so
// the row's max and each of the k rounds are single-instruction warp
// reductions (redux.sync): the max over the lanes' best, then the min index
// among the lanes that hold it (the lowest index wins ties); the winner
// drops below every other entry. Lane r keeps round r's pick, so the
// renormalized row (the picks summed in round order) leaves in one
// coalesced store.
//
// The fused entry:
//  * D is cut into ``splits`` spans (the plan, kernels/topk_gate.py:
//    router_plan, reads D and E only), one block each; the splits of a row
//    tile form one thread block cluster (up to 16, non-portable above 8).
//    At D 2048 a block's span of the router (64 KB at E 128, its rows
//    contiguous) is ONE TMA bulk copy (cp.async.bulk) completing on an
//    mbarrier; 4096 16-byte cp.async a block took longer to issue than the
//    copy took to land. Longer spans stream through a ring of 32-row
//    chunks, a bulk copy each. The tile's x comes by 16-byte cp.async (a
//    bulk copy a row would be 32 TMA requests a block at T = 512); bf16 x
//    becomes f32 once, not at every product.
//  * A thread owns R rows x CV columns of the tile's logits (one column a
//    thread at decode, so 128 threads share the work) and adds its products
//    in the order of D: one sequential f32 chain per span. (Four chains a
//    span, one a chunk, interleaved were slower at decode: their extra
//    registers spill.)
//  * The block of rank s selects the tile rows s, s + splits, ...; every
//    block stores its chains for those rows straight into that block's
//    shared memory (distributed shared memory), one cluster barrier, and
//    each block sums its rows' partials in split order from its own shared
//    memory (every thread a few entries). No workspace, no atomics, no
//    reads across the cluster.
//  * A row's logits are therefore the same sums in the same order whatever
//    the row tile or T (the tile sets only how many rows share a block's
//    loads): row t gives the same bits at T = 1, 5 or 512, on every launch.
//  * The E-split variant (etiles > 1, a sweep option): E is cut into tiles,
//    each with its own clusters, so more SMs pull the router; the merged
//    logits of a tile go to a workspace and the last cluster of a row tile
//    to finish (a zeroed counter per row tile) selects.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

constexpr int GT_THREADS = 256;      // a block of the fused entry
constexpr int GT_WARPS = GT_THREADS / 32;
constexpr int RT_CHUNK = 32;         // router rows per ring stage
constexpr int RT_MAXSTAGES = 4;
constexpr int RT_MAXSPLITS = 16;     // the blocks of one (non-portable) cluster
constexpr int RT_MAXE = 1024;        // a row group of 4 columns a thread spans E
constexpr size_t GT_SMEM = 232448 - 1024;   // dynamic shared memory, beside the static
constexpr float PAD = -2.0f;         // entries past E: below every probability

static int lanes_nv(int E) {         // values per lane of a register row; 0: a shared row
    return E <= 32 ? 1 : E <= 64 ? 2 : E <= 128 ? 4 : E <= 256 ? 8 : 0;
}
static int round4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// selection
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ordered(float f) {     // monotone in f
    const uint32_t b = __float_as_uint(f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
// round r's pick reaches every lane; lane r keeps it, rounds past 32 are
// stored at once (unnormalized); the renormalization sums the picks in
// round order
struct Picks {
    float w = 0.f, wsum = 0.f;
    int id = 0;
    __device__ __forceinline__ void take(float p, int e, int r, int lane, int32_t* ids,
                                         float* weights) {
        wsum += p;
        if (r < 32) {
            if (lane == r) { w = p; id = e; }
        } else if (lane == 0) {
            ids[r] = e;
            weights[r] = p;
        }
    }
    __device__ __forceinline__ void store(int k, int normalize, int lane, int32_t* ids,
                                          float* weights) const {
        const float d = fmaxf(wsum, 1e-9f);
        if (lane < k) {
            ids[lane] = id;
            weights[lane] = normalize ? w / d : w;
        }
        if (normalize && k > 32) {
            __syncwarp();
            for (int r = 32 + lane; r < k; r += 32) weights[r] /= d;
        }
    }
};

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t TAKEN = 0u;       // an ordered value below every other

// One row, one warp: v[j] holds logit lane + 32 j (entries at or past E
// are ignored). Writes the row's k ids and weights.
template <int NV>
__device__ __forceinline__ void select_row(float (&v)[NV], int E, int k, int normalize,
                                           int32_t* ids, float* weights, int lane) {
    uint32_t mo = 0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
        if (lane + 32 * j < E) mo = max(mo, ordered(v[j]));
    const float m = unordered(__reduce_max_sync(FULL, mo));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
        if (lane + 32 * j < E) {
            v[j] = expf(v[j] - m);
            s += v[j];
        }
    s = warp_sum(s);
    uint32_t o[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) o[j] = ordered(lane + 32 * j < E ? v[j] / s : PAD);
    Picks picks;
    for (int r = 0; r < k; ++r) {
        uint32_t best = o[0];
        int at = lane;                                    // '>' in ascending j keeps the lowest
#pragma unroll
        for (int j = 1; j < NV; ++j)
            if (o[j] > best) { best = o[j]; at = lane + 32 * j; }
        const uint32_t top = __reduce_max_sync(FULL, best);
        const int e = (int)__reduce_min_sync(FULL, best == top ? (uint32_t)at : 0xffffffffu);
#pragma unroll
        for (int j = 0; j < NV; ++j)
            if (lane + 32 * j == e) o[j] = TAKEN;
        picks.take(unordered(top), e, r, lane, ids, weights);
    }
    picks.store(k, normalize, lane, ids, weights);
}

// The same on a row of E logits in the warp's own shared memory (E > 256).
__device__ void select_row_smem(float* p, int E, int k, int normalize, int32_t* ids,
                                float* weights, int lane) {
    __syncwarp();
    uint32_t mo = 0;
    for (int e = lane; e < E; e += 32) mo = max(mo, ordered(p[e]));
    const float m = unordered(__reduce_max_sync(FULL, mo));
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
        const float v = expf(p[e] - m);
        p[e] = v;
        s += v;
    }
    s = warp_sum(s);
    for (int e = lane; e < E; e += 32) p[e] = p[e] / s;
    Picks picks;
    for (int r = 0; r < k; ++r) {
        uint32_t best = 0;
        int at = E;
        for (int e = lane; e < E; e += 32) {
            const uint32_t oe = ordered(p[e]);
            if (oe > best) { best = oe; at = e; }
        }
        const uint32_t top = __reduce_max_sync(FULL, best);
        const int e = (int)__reduce_min_sync(FULL, best == top ? (uint32_t)at : 0xffffffffu);
        if (e % 32 == lane) p[e] = -1.0f;                 // taken: below every probability
        picks.take(unordered(top), e, r, lane, ids, weights);
    }
    picks.store(k, normalize, lane, ids, weights);
}

// One warp selects row ``row`` whose logits are ``logit(e)``.
template <typename Logit>
__device__ __forceinline__ void select_warp(int nv, Logit logit, int E, int k, int normalize,
                                            float* rowbuf, int32_t* ids, float* weights,
                                            int lane) {
    auto regs = [&](auto tag) {
        constexpr int NV = decltype(tag)::value;
        float v[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = lane + 32 * j < E ? logit(lane + 32 * j) : 0.f;
        select_row<NV>(v, E, k, normalize, ids, weights, lane);
    };
    switch (nv) {
        case 1: regs(std::integral_constant<int, 1>{}); break;
        case 2: regs(std::integral_constant<int, 2>{}); break;
        case 4: regs(std::integral_constant<int, 4>{}); break;
        case 8: regs(std::integral_constant<int, 8>{}); break;
        default:
            for (int e = lane; e < E; e += 32) rowbuf[e] = logit(e);
            select_row_smem(rowbuf, E, k, normalize, ids, weights, lane);
    }
}

// ---------------------------------------------------------------------------
// logits-in entry: one warp per row, 4 rows a block
// ---------------------------------------------------------------------------
constexpr int TK_WARPS = 4;

__global__ void __launch_bounds__(32 * TK_WARPS)
topk_gate_kernel(const float* __restrict__ logits, int T, int E, int k, int normalize, int nv,
                 int32_t* __restrict__ ids, float* __restrict__ weights) {
    extern __shared__ float gate_rows[];                    // E > 256: a row per warp
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = blockIdx.x * TK_WARPS + warp;
    if (row >= T) return;
    const float* x = logits + (size_t)row * E;
    select_warp(nv, [&](int e) { return x[e]; }, E, k, normalize, gate_rows + (size_t)warp * E,
                ids + (size_t)row * k, weights + (size_t)row * k, lane);
}

extern "C" int topk_gate_f32(const void* logits, int T, int E, int k, int normalize,
                             void* ids, void* weights, void* stream) {
    if (T < 1 || E < 1 || k < 1 || k > E) return (int)cudaErrorInvalidValue;
    const int nv = lanes_nv(E);
    const size_t smem = nv ? 0 : (size_t)TK_WARPS * E * sizeof(float);
    if (smem > GT_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            topk_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    topk_gate_kernel<<<(T + TK_WARPS - 1) / TK_WARPS, 32 * TK_WARPS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), T, E, k, normalize, nv, static_cast<int32_t*>(ids),
        static_cast<float*>(weights));
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused entry: router GEMM + gate
// ---------------------------------------------------------------------------
struct RouterArgs {
    const void* x;        // [T, D] XT
    const float* w;       // [D, E] f32
    int32_t* ids;         // [T, k]
    float* weights;       // [T, k]
    float* ws;            // E-split only: merged logits [T, E]
    int* counters;        // E-split only: one per row tile, zeroed by the caller
    int T, D, E, k, normalize;
    int span, rows;       // rows of D per split; rows of T per tile
    int ecols, stages, nv, vec;
    size_t front;         // bytes of the front region: the ring, later the selection
};

__device__ __forceinline__ void cp_async_wait_n(int n) {  // n groups may stay in flight
    if (n <= 0) cp_async_wait<0>();
    else if (n == 1) cp_async_wait<1>();
    else if (n == 2) cp_async_wait<2>();
    else cp_async_wait<3>();
}

// TMA bulk copies (global -> this block's shared memory) completing on an
// mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
    for (long spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
        if (done) return;
        if (spins > (1l << 22)) __trap();      // a copy that never lands: fail, do not hang
    }
}

template <int CV>
__device__ __forceinline__ void load_w(const float* p, float (&o)[CV]) {
    if constexpr (CV == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else {
#pragma unroll
        for (int c = 0; c < CV; ++c) o[c] = p[c];
    }
}

// acc[r][j] += x[r][d] * w[d][j] for the 4 rows d = dd .. dd + 3, in order
template <int R, int CV>
__device__ __forceinline__ void chain4(float (&acc)[R][CV], const float* xd, int xs,
                                       const float* wd, int ldw, int dd) {
    float xv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(xd + r * xs + dd);
        xv[r][0] = v.x; xv[r][1] = v.y; xv[r][2] = v.z; xv[r][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        float wv[CV];
        load_w<CV>(wd + (dd + q) * ldw, wv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < CV; ++j) acc[r][j] = fmaf(xv[r][q], wv[j], acc[r][j]);
    }
}

// a chunk's rows d < n, in order, onto acc (the span's one sequential f32
// chain): x rows ``xs`` apart, router rows ``ldw``; a whole chunk unrolled
template <int R, int CV>
__device__ __forceinline__ void chain(float (&acc)[R][CV], const float* xd, int xs,
                                      const float* wd, int ldw, int n) {
    if (n == RT_CHUNK) {
#pragma unroll
        for (int dd = 0; dd < RT_CHUNK; dd += 4) chain4<R, CV>(acc, xd, xs, wd, ldw, dd);
    } else {
#pragma unroll 2
        for (int dd = 0; dd < n; dd += 4) chain4<R, CV>(acc, xd, xs, wd, ldw, dd);
    }
}

// block (split, row tile, E tile); see the note at the top. Shared memory:
// [front: the ring of router chunks, later the selection][x ring: stages x
// rows x 32 XT][bf16 x only: the same in f32][inbox: splits x slots x ldw
// partials of the rows this block selects]
template <typename XT, int R, int CV>
__global__ void __launch_bounds__(GT_THREADS) router_topk_kernel(RouterArgs a) {
    extern __shared__ __align__(16) unsigned char rt_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int split = blockIdx.x, splits = gridDim.x, tile = blockIdx.y;
    const int tid = threadIdx.x;
    const int row0 = tile * a.rows, nrows = min(a.rows, a.T - row0);
    const int e0 = blockIdx.z * a.ecols, ncols = min(a.E - e0, a.ecols);
    const int ldw = (a.ecols + 3) & ~3;                     // floats per shared row
    const int slots = (a.rows + splits - 1) / splits;      // rows a block selects, at most
    const int d0 = split * a.span, d1 = min(a.D, d0 + a.span);
    const int nchunks = (d1 - d0 + RT_CHUNK - 1) / RT_CHUNK;
    constexpr bool CONVERT = sizeof(XT) != 4;               // bf16 x: converted to f32 once
    float* Ws = reinterpret_cast<float*>(rt_smem);                          // [stages][CHUNK][ldw]
    XT* Xr = reinterpret_cast<XT*>(rt_smem + a.front);                     // [stages][rows][CHUNK]
    float* Xf = reinterpret_cast<float*>(Xr + (size_t)a.stages * a.rows * RT_CHUNK);  // [stages][rows][CHUNK]
    float* inbox = Xf + (CONVERT ? (size_t)a.stages * a.rows * RT_CHUNK : 0);  // [splits][slots][ldw]
    const XT* X = static_cast<const XT*>(a.x);

    // vec: one mbarrier a stage, which the stage's TMA copies complete
    __shared__ __align__(8) uint64_t bars[RT_MAXSTAGES];
    if (a.vec && tid == 0) {
        for (int st = 0; st < a.stages; ++st) mbar_init(&bars[st], 1);
        fence_mbar_init();
    }
    __syncthreads();

    // chunk c (router rows r0 = d0 + 32c, n of them) and the tile's x beside
    // it into stage c % stages. vec: the router chunk as ONE TMA bulk copy
    // completing on the stage's mbarrier when the E tile is whole rows (else
    // 16-byte cp.async), x by 16-byte cp.async; rows past T are not copied
    // and never stored. Otherwise every thread copies, reading rows past the
    // span and past T as zeros.
    auto issue = [&](int c, int st) {
        const int r0 = d0 + c * RT_CHUNK, n = min(RT_CHUNK, d1 - r0);
        float* wd = Ws + (size_t)st * RT_CHUNK * ldw;
        XT* xd = Xr + (size_t)st * a.rows * RT_CHUNK;
        if (a.vec) {
            const bool bulk = ncols == a.E;
            if (tid == 0) {
                mbar_expect_tx(&bars[st], bulk ? n * ncols * 4 : 0);
                if (bulk) tma_load(wd, a.w + (size_t)r0 * a.E, n * ncols * 4, &bars[st]);
            }
            if (!bulk) {
                const int q4 = ncols / 4;
                for (int i = tid; i < n * q4; i += GT_THREADS)
                    cp_async16(wd + (i / q4) * ldw + (i % q4) * 4,
                               a.w + (size_t)(r0 + i / q4) * a.E + e0 + (i % q4) * 4, true);
            }
            constexpr int XQ = 16 / (int)sizeof(XT), XP = RT_CHUNK / XQ;   // 16-byte pieces a row
            const int q = tid % XP;                             // constant divisors: shifts
            if (q * XQ < n)
                for (int r = tid / XP; r < nrows; r += GT_THREADS / XP)
                    cp_async16(xd + r * RT_CHUNK + q * XQ, X + (size_t)(row0 + r) * a.D + r0 + q * XQ,
                               true);
            cp_async_commit();
            return;
        }
        for (int i = tid; i < RT_CHUNK * ldw; i += GT_THREADS) {
            const int r = i / ldw, e = i % ldw;
            wd[i] = r < n && e < ncols ? a.w[(size_t)(r0 + r) * a.E + e0 + e] : 0.f;
        }
        for (int i = tid; i < a.rows * RT_CHUNK; i += GT_THREADS) {
            const int r = i / RT_CHUNK, d = r0 + i % RT_CHUNK;
            xd[i] = r < nrows && d < d1 ? X[(size_t)(row0 + r) * a.D + d] : from_f<XT>(0.f);
        }
    };

    const int ncg = ldw / CV;                                 // column groups of CV
    const int rg = tid / ncg, cgi = tid % ncg;
    const bool active = rg < a.rows / R && rg * R < nrows;
    float acc[R][CV];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < CV; ++j) acc[r][j] = 0.f;

    if (nchunks <= a.stages) {
        // the whole span at once (D 2048): the router span as ONE bulk copy
        // (its rows are contiguous) when the E tile is whole rows, x laid
        // out [rows][span]; one wait, one conversion, then the span's chain
        // with no barrier between chunks
        const int nspan = d1 - d0, xs = a.stages * RT_CHUNK;   // x row stride: the x ring's size
        if (a.vec) {
            if (ncols == a.E) {
                if (tid == 0) {
                    mbar_expect_tx(&bars[0], nspan * ncols * 4);
                    tma_load(Ws, a.w + (size_t)d0 * a.E, nspan * ncols * 4, &bars[0]);
                }
            } else {
                if (tid == 0) mbar_expect_tx(&bars[0], 0);
                const int q4 = ncols / 4;
                for (int i = tid; i < nspan * q4; i += GT_THREADS)
                    cp_async16(Ws + (i / q4) * ldw + (i % q4) * 4,
                               a.w + (size_t)(d0 + i / q4) * a.E + e0 + (i % q4) * 4, true);
            }
            constexpr int XQ = 16 / (int)sizeof(XT);        // x values a 16-byte piece
            const int xp = nspan / XQ;
            for (int i = tid; i < nrows * xp; i += GT_THREADS) {
                const int r = i / xp, q = i - r * xp;
                cp_async16(Xr + (size_t)r * xs + q * XQ, X + (size_t)(row0 + r) * a.D + d0 + q * XQ,
                           true);
            }
            cp_async_commit();
            cp_async_wait<0>();
            mbar_wait(&bars[0], 0);
        } else {
            for (int i = tid; i < xs * ldw; i += GT_THREADS) {
                const int r = i / ldw, e = i % ldw;
                Ws[i] = r < nspan && e < ncols ? a.w[(size_t)(d0 + r) * a.E + e0 + e] : 0.f;
            }
            for (int i = tid; i < a.rows * xs; i += GT_THREADS) {
                const int r = i / xs, d = d0 + i % xs;
                Xr[i] = r < nrows && d < d1 ? X[(size_t)(row0 + r) * a.D + d] : from_f<XT>(0.f);
            }
        }
        __syncthreads();
        if constexpr (CONVERT) {
            for (int i = tid; i < nrows * xs; i += GT_THREADS) Xf[i] = to_f(Xr[i]);
            __syncthreads();
        }
        const float* xf = CONVERT ? Xf : reinterpret_cast<const float*>(Xr);
        if (active)
            for (int c = 0; c * RT_CHUNK < nspan; ++c)
                chain<R, CV>(acc, xf + (size_t)rg * R * xs + c * RT_CHUNK, xs,
                             Ws + (size_t)c * RT_CHUNK * ldw + cgi * CV, ldw,
                             (min(RT_CHUNK, nspan - c * RT_CHUNK) + 3) & ~3);
    } else {
        for (int c = 0; c < a.stages; ++c) issue(c, c);
        for (int c = 0, st = 0, phase = 0; c < nchunks; ++c) {   // chunk c sits in stage st
            if (a.vec) {
                cp_async_wait_n(min(nchunks, c + a.stages) - c - 1);
                mbar_wait(&bars[st], phase);
            }
            __syncthreads();
            const XT* xr = Xr + (size_t)st * a.rows * RT_CHUNK;
            if constexpr (CONVERT) {
                for (int i = tid; i < a.rows * RT_CHUNK; i += GT_THREADS) Xf[i] = to_f(xr[i]);
                __syncthreads();
            }
            if (active)
                chain<R, CV>(acc, (CONVERT ? Xf : reinterpret_cast<const float*>(xr)) + rg * R * RT_CHUNK,
                             RT_CHUNK, Ws + (size_t)st * RT_CHUNK * ldw + cgi * CV, ldw,
                             (min(RT_CHUNK, d1 - (d0 + c * RT_CHUNK)) + 3) & ~3);
            __syncthreads();                                  // stage st free again
            if (c + a.stages < nchunks) issue(c + a.stages, st);
            if (++st == a.stages) {
                st = 0;
                phase ^= 1;
            }
        }
    }

    // this span's chains of row lr go to the inbox of block lr % splits
    if (active) {
        int to = (rg * R) % splits, slot = (rg * R) / splits;   // row lr: block lr % splits
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int lr = rg * R + r;
            if (lr < nrows) {
                float* dst = cluster.map_shared_rank(inbox, to)
                             + ((size_t)split * slots + slot) * ldw + cgi * CV;
                if constexpr (CV == 4)
                    *reinterpret_cast<float4*>(dst) =
                        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
                else
#pragma unroll
                    for (int j = 0; j < CV; ++j) dst[j] = acc[r][j];
            }
            if (++to == splits) {
                to = 0;
                ++slot;
            }
        }
    }
    cluster.sync();                                           // every span's chains have landed

    // my rows' logits, the partials summed in split order, by every thread
    // into the front region (the ring is free again), one warp a row then
    // selects
    const int ldp = (a.E + 3) & ~3, mine = nrows > split ? (nrows - split + splits - 1) / splits : 0;
    float* L = reinterpret_cast<float*>(rt_smem);          // [mine][ldp]
    for (int j = tid / ncols, e = tid % ncols; j < mine;) {   // (j, e) walks [mine][ncols]
        const float* in = inbox + (size_t)j * ldw + e;
        float p[RT_MAXSPLITS];
#pragma unroll
        for (int q = 0; q < RT_MAXSPLITS; ++q) p[q] = q < splits ? in[(size_t)q * slots * ldw] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < RT_MAXSPLITS; ++q)
            if (q < splits) s += p[q];
        if (a.ws == nullptr) L[j * ldp + e] = s;
        else a.ws[(size_t)(row0 + split + j * splits) * a.E + e0 + e] = s;
        for (e += GT_THREADS; e >= ncols; ++j) e -= ncols;
    }
    const int warp = tid / 32, lane = tid % 32;
    if (a.ws == nullptr) {
        __syncthreads();
        for (int j = warp; j < mine; j += GT_WARPS) {
            const int row = row0 + split + j * splits;
            float* Lj = L + (size_t)j * ldp;
            select_warp(a.nv, [&](int e) { return Lj[e]; }, a.E, a.k, a.normalize, Lj,
                        a.ids + (size_t)row * a.k, a.weights + (size_t)row * a.k, lane);
        }
        return;
    }

    // E-split: the last E tile of the row tile to finish selects its rows
    // from the workspace
    __threadfence();
    cluster.sync();
    if (split != 0) return;
    __shared__ int last;
    if (tid == 0) last = atomicAdd(a.counters + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int r = warp; r < nrows; r += GT_WARPS) {
        const float* src = a.ws + (size_t)(row0 + r) * a.E;
        select_warp(a.nv, [&](int e) { return __ldcg(src + e); }, a.E, a.k, a.normalize,
                    L + (size_t)warp * ldp, a.ids + (size_t)(row0 + r) * a.k,
                    a.weights + (size_t)(row0 + r) * a.k, lane);
    }
}

template <typename XT, int R, int CV>
static int launch_router(const RouterArgs& a, int splits, size_t smem, cudaStream_t st) {
    auto kernel = router_topk_kernel<XT, R, CV>;
    static size_t allowed[64] = {};       // shared memory allowed so far, per instantiation and card
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || allowed[dev] < smem) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) allowed[dev] = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (a.T + a.rows - 1) / a.rows, (a.E + a.ecols - 1) / a.ecols);
    cfg.blockDim = dim3(GT_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = splits;                     // the splits of one row tile
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The plan's checks: ``splits`` spans of ``span`` rows (a multiple of the
// chunk) cover D, none wholly past it, in one cluster; R rows by CV (1 or
// 4) columns a thread, the tile's row groups fit the block; the E tiles
// (whole 16-byte rows) cover E; the shared memory fits.
template <typename XT>
static int launch_fused(const void* x, const void* w, int T, int D, int E, int k, int normalize,
                        int splits, int span, int R, int CV, int rows, int etiles, int ecols,
                        void* ws, void* counters, void* ids, void* weights, void* stream) {
    if (T < 1 || D < 1 || E < 1 || E > RT_MAXE || k < 1 || k > E) return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > RT_MAXSPLITS || span < RT_CHUNK || span % RT_CHUNK
        || (long)splits * span < D || (long)(splits - 1) * span >= D)
        return (int)cudaErrorInvalidValue;
    if (etiles < 1 || (etiles == 1 && ecols != E)
        || (etiles > 1 && (ecols % 4 || (long)etiles * ecols < E || (long)(etiles - 1) * ecols >= E
                           || ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int ldw = round4(ecols);
    if ((CV != 1 && CV != 4) || rows < R || rows % R || (rows / R) * (ldw / CV) > GT_THREADS)
        return (int)cudaErrorInvalidValue;
    // as many chunks in flight as the span has, up to 4, fewer where a wide
    // E would not fit; the ring's region holds the selection afterwards
    const int slots = (rows + splits - 1) / splits;
    const size_t logits = (size_t)(slots > GT_WARPS ? slots : GT_WARPS) * round4(E) * 4;
    auto smem_of = [&](int n, size_t* front) {
        size_t f = (size_t)n * RT_CHUNK * ldw * 4;
        if (f < logits) f = logits;
        *front = (f + 15) & ~(size_t)15;
        return *front + (size_t)n * rows * RT_CHUNK * sizeof(XT)
               + (sizeof(XT) != 4 ? (size_t)n * rows * RT_CHUNK * 4 : 0) + (size_t)splits * slots * ldw * 4;
    };
    int stages = span / RT_CHUNK < RT_MAXSTAGES ? span / RT_CHUNK : RT_MAXSTAGES;
    size_t front = 0;
    while (stages > 1 && smem_of(stages, &front) > GT_SMEM) --stages;
    const size_t smem = smem_of(stages, &front);
    if (smem > GT_SMEM) return (int)cudaErrorInvalidValue;
    const int vec = E % 4 == 0 && ecols % 4 == 0 && D % (16 / (int)sizeof(XT)) == 0
                    && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    RouterArgs a{x, static_cast<const float*>(w), static_cast<int32_t*>(ids),
                 static_cast<float*>(weights), etiles > 1 ? static_cast<float*>(ws) : nullptr,
                 static_cast<int*>(counters), T, D, E, k, normalize, span, rows, ecols, stages,
                 lanes_nv(E), vec, front};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (CV == 1) {
        switch (R) {
            case 1: return launch_router<XT, 1, 1>(a, splits, smem, st);
            case 2: return launch_router<XT, 2, 1>(a, splits, smem, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    switch (R) {
        case 1: return launch_router<XT, 1, 4>(a, splits, smem, st);
        case 2: return launch_router<XT, 2, 4>(a, splits, smem, st);
        case 4: return launch_router<XT, 4, 4>(a, splits, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

#define ROUTER_ENTRY(NAME, XT)                                                                   \
    extern "C" int NAME(const void* x, const void* w, int T, int D, int E, int k, int normalize,  \
                        int splits, int span, int R, int CV, int rows, int etiles, int ecols,     \
                        void* ws, void* counters, void* ids, void* weights, void* stream) {       \
        return launch_fused<XT>(x, w, T, D, E, k, normalize, splits, span, R, CV, rows, etiles,  \
                                ecols, ws, counters, ids, weights, stream);                      \
    }
ROUTER_ENTRY(router_topk_bf16, __nv_bfloat16)
ROUTER_ENTRY(router_topk_f32, float)
